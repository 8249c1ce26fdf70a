"""
Host-side plotting helpers (matplotlib), a copy of audio_analysis_tpu/plot:
the house style (10x6 in at 100 dpi, grid on, save the PNG and close when
an output path is given, otherwise an interactive show), the Hz tick
treatment of every log-frequency plot, the stable tight-bbox cache, the
live figure templates, min-max display decimation, the log-frequency
image and the reference's five generic drawing helpers. Host numpy only:
the figure functions of the port's analyses import this module inside
themselves, so the package and every path that draws no figure load no
matplotlib.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import os as _os

import matplotlib

# Headless-safe default WITHOUT killing interactive use: matplotlib.use()
# would override an MPLBACKEND the user set (pyplot is imported right
# below, so the rcParam would win), and on a desktop it would silently
# turn every plt.show() into a no-op. Only force Agg when there is neither
# a user-chosen backend nor a display to show on.
import sys as _sys

if (
    "MPLBACKEND" not in _os.environ
    and _sys.platform != "darwin"  # macOS shows windows without DISPLAY
    and not (_os.environ.get("DISPLAY") or _os.environ.get("WAYLAND_DISPLAY"))
):
    matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import matplotlib.ticker as mticker  # noqa: E402
import numpy as np  # noqa: E402

from dataclasses import dataclass  # noqa: E402


@dataclass(frozen=True)
class FigureStyle:
    """House style for every figure the framework emits (10x6 in @ 100 dpi,
    grid on — the same visual contract as the reference toolkit's plots)."""

    width_inches: float = 10.0
    height_inches: float = 6.0
    dpi: int = 100
    grid: bool = True

    @property
    def size(self) -> Tuple[float, float]:
        return (self.width_inches, self.height_inches)


HOUSE_STYLE = FigureStyle()

# Back-compat constants (several analyses read these directly).
DEFAULT_FIGURE_SIZE = HOUSE_STYLE.size
DEFAULT_DPI = HOUSE_STYLE.dpi
DEFAULT_GRID = HOUSE_STYLE.grid


def create_figure_and_axis(
    title: Optional[str] = None,
    figure_size: Optional[Tuple[float, float]] = None,
    style: FigureStyle = HOUSE_STYLE,
) -> Tuple[plt.Figure, plt.Axes]:
    """One styled figure with a single axes; title and grid pre-applied.
    `figure_size` overrides the style's size when given."""
    figure = plt.figure(figsize=figure_size or style.size, dpi=style.dpi)
    axis = figure.add_subplot(1, 1, 1, title=title)
    axis.grid(style.grid)
    return figure, axis


# ----------------------------------------------------------------------------
# tight-bbox cache — skip savefig's per-figure layout pass on repeat layouts.
#
# `bbox_inches="tight"` costs a full layout pass (tick construction + text
# metrics, ~40 ms per figure here) BEFORE the real draw. The tight crop is
# the UNION of every visible artist's window extent, so it splits cleanly
# into (a) a STABLE part — axes frame, ticks, axis labels, legend — that is
# a pure function of the figure layout, and (b) the volatile per-call texts
# (titles and free text carry the input path, so they change every tap of a
# bundle). The cache stores the stable union once per layout key (computed
# with the volatile texts hidden); each save then unions the CURRENT text
# extents back in — a few cached text measures instead of a full layout
# pass, and exact by construction, so output bytes match the plain "tight"
# path even when titles differ tap to tap. 3D axes fingerprint via
# view/limits/labels (their tight bbox ignores the plotted collections);
# figures the key cannot fully cover (legends anchored outside the axes,
# exotic projections) fall back to the plain "tight" path.

_TIGHT_BBOX_CACHE: dict = {}
_TIGHT_BBOX_CACHE_MAX = 512
TIGHT_BBOX_CACHE_ENABLED = True


def clear_tight_bbox_cache() -> None:
    _TIGHT_BBOX_CACHE.clear()


def _round6(values) -> Tuple[float, ...]:
    return tuple(round(float(v), 6) for v in np.atleast_1d(values))


def _volatile_texts(figure: plt.Figure) -> list:
    """The per-call text artists excluded from the layout key: figure-level
    texts (suptitle), axes titles, and free axes texts. Their extents are
    unioned back into the crop at save time."""
    out = list(figure.texts)
    for ax in figure.get_axes():
        for artist in (
            getattr(ax, "title", None),
            getattr(ax, "_left_title", None),
            getattr(ax, "_right_title", None),
        ):
            if artist is not None:
                out.append(artist)
        out.extend(ax.texts)
    return [t for t in out if t.get_visible() and t.get_text()]


def _axis_text_key(axis) -> Optional[tuple]:
    """Tick strings + offset text for one x/y axis, computed WITHOUT a
    layout pass (locator + formatter only)."""
    parts = []
    for which in ("major", "minor"):
        locs = axis.get_majorticklocs() if which == "major" else axis.get_minorticklocs()
        formatter = (
            axis.get_major_formatter() if which == "major" else axis.get_minor_formatter()
        )
        labels = tuple(formatter.format_ticks(locs))
        offset = ""
        get_offset = getattr(formatter, "get_offset", None)
        if callable(get_offset):
            offset = str(get_offset())
        parts.append((_round6(locs), labels, offset))
    return tuple(parts)


def _figure_layout_key(figure: plt.Figure) -> Optional[tuple]:
    """Hashable fingerprint of everything that can move the tight crop box,
    or None when the figure has elements the fingerprint can't cover."""
    try:
        parts: list = [
            _round6(figure.get_size_inches()),
            round(float(figure.dpi), 6),
        ]
        for ax in figure.get_axes():
            name = getattr(ax, "name", "rectilinear")
            if name not in ("rectilinear", "3d"):
                return None
            leg = ax.get_legend()
            leg_key = ()
            if leg is not None:
                if getattr(leg, "_bbox_to_anchor", None) is not None:
                    return None  # may hang outside the axes, data-positioned
                # an un-anchored legend is placed INSIDE the axes, whose
                # frame+labels already bound the crop — its per-tap label
                # strings (peak/centroid values) cannot move the tight bbox
                # ... UNLESS the legend is so large it overflows the frame.
                # Conservatively over-estimate its size from the label
                # extents; bail to the plain tight pass when it could poke.
                renderer = figure.canvas.get_renderer()
                widths, heights = [0.0], [0.0]
                for t in leg.get_texts():
                    ext = t.get_window_extent(renderer)
                    widths.append(float(ext.width))
                    heights.append(float(ext.height))
                fs = float(leg.prop.get_size_in_points()) * figure.dpi / 72.0
                est_w = max(widths) + 4.0 * fs  # handle + pads
                est_h = sum(heights) * 1.6 + 2.0 * fs
                ax_bbox = ax.get_window_extent(renderer)
                if est_w > 0.95 * ax_bbox.width or est_h > 0.95 * ax_bbox.height:
                    return None
                leg_key = ("legend-inside", len(leg.get_texts()))
            if name == "3d":
                # Axes3D.get_tightbbox covers the axes rectangle + the
                # projected ticks/labels — NOT the plotted collections —
                # so the crop is a function of view + limits + label
                # strings only (verified: data 200 dB outside zlim leaves
                # the bbox bit-identical).
                box_aspect = ax.get_box_aspect()
                parts.append(
                    (
                        "3d",
                        _round6(ax.get_position().bounds),
                        ax.get_xlabel(),
                        ax.get_ylabel(),
                        ax.get_zlabel(),
                        _round6((ax.elev, ax.azim, getattr(ax, "roll", 0.0) or 0.0)),
                        _round6(box_aspect) if box_aspect is not None else (),
                        str(getattr(ax, "_focal_length", "")),
                        _round6(ax.get_xlim()),
                        _round6(ax.get_ylim()),
                        _round6(ax.get_zlim()),
                        _axis_text_key(ax.xaxis),
                        _axis_text_key(ax.yaxis),
                        _axis_text_key(ax.zaxis),
                        leg_key,
                    )
                )
                continue
            parts.append(
                (
                    _round6(ax.get_position().bounds),
                    ax.get_xlabel(),
                    ax.get_ylabel(),
                    ax.get_xscale(),
                    ax.get_yscale(),
                    _round6(ax.get_xlim()),
                    _round6(ax.get_ylim()),
                    _axis_text_key(ax.xaxis),
                    _axis_text_key(ax.yaxis),
                    leg_key,
                )
            )
        return tuple(parts)
    except Exception:
        return None


def _stable_tight_bbox(figure: plt.Figure):
    """The UNPADDED tight bbox of everything except the volatile texts —
    one layout pass (draw with rendering disabled, volatile texts hidden),
    mirroring backend_bases.print_figure's tight branch. Hiding a title or
    free text removes only its extent from the union: with the plain
    subplot layouts used here (no constrained/tight layout), text
    visibility moves no other artist."""
    from contextlib import nullcontext

    texts = _volatile_texts(figure)
    visible = [t.get_visible() for t in texts]
    # _update_title_position recomputes hidden titles against a degenerate
    # top edge during the draw below — snapshot positions and restore them
    positions = [t.get_position() for t in texts]
    try:
        for t in texts:
            t.set_visible(False)
        renderer = figure.canvas.get_renderer()
        with getattr(renderer, "_draw_disabled", nullcontext)():
            figure.draw(renderer)
        return figure.get_tightbbox(renderer)
    finally:
        for t, v, p in zip(texts, visible, positions):
            t.set_visible(v)
            t.set_position(p)


def _bbox_with_volatile_texts(figure: plt.Figure, stable_bbox):
    """Union the current volatile-text window extents (figure-inch units)
    back into the cached stable bbox, then apply savefig's pad — the exact
    crop the full tight pass would produce for this figure."""
    import matplotlib.transforms as mtransforms

    renderer = figure.canvas.get_renderer()
    dpi = float(figure.dpi)
    boxes = [stable_bbox]
    for t in _volatile_texts(figure):
        ext = t.get_window_extent(renderer)  # display pixels
        boxes.append(
            mtransforms.Bbox.from_extents(
                ext.x0 / dpi, ext.y0 / dpi, ext.x1 / dpi, ext.y1 / dpi
            )
        )
    pad = float(matplotlib.rcParams["savefig.pad_inches"])
    return mtransforms.Bbox.union(boxes).padded(pad, pad)


def _save_tight(figure: plt.Figure, target: Path) -> None:
    bbox = "tight"
    key = _figure_layout_key(figure) if TIGHT_BBOX_CACHE_ENABLED else None
    if key is not None:
        stable = _TIGHT_BBOX_CACHE.get(key)
        if stable is None:
            try:
                stable = _stable_tight_bbox(figure)
            except Exception:
                stable = None
            if stable is not None:
                if len(_TIGHT_BBOX_CACHE) >= _TIGHT_BBOX_CACHE_MAX:
                    _TIGHT_BBOX_CACHE.clear()
                _TIGHT_BBOX_CACHE[key] = stable
        if stable is not None:
            try:
                bbox = _bbox_with_volatile_texts(figure, stable)
            except Exception:
                bbox = "tight"
    # Pillow writer at compress level 1: ~2x faster PNG encode than the
    # default zlib-6 for a few % larger files. Tight bbox kept
    # (plotting.py:67 contract — same cropped dimensions).
    try:
        figure.savefig(target, bbox_inches=bbox, pil_kwargs={"compress_level": 1})
    except TypeError:  # matplotlib without PIL writer support
        figure.savefig(target, bbox_inches=bbox)


# ----------------------------------------------------------------------------
# live figure templates — the render path draws the same ~15 figure layouts
# for every tap of a bundle, and axes/tick/colorbar CONSTRUCTION is ~40% of
# a figure's render cost (measured: spectrogram 376 -> 211 ms steady-state).
# A template keeps one live figure per figure kind; update() re-applies only
# the data-dependent artists (image data, line data, clim, extent, title).
# Byte-identity with the fresh-figure path is enforced by a test per
# templated kind (tests/test_torch_report.py) so the build and update
# paths cannot drift apart silently. Matplotlib is not thread-safe:
# templates are module state used only by the single render thread (or one
# per process-pool worker) — parallel/overlap.py, parallel/procpool.py.

_FIGURE_TEMPLATES: dict = {}
FIGURE_TEMPLATES_ENABLED = True


def clear_figure_templates() -> None:
    for _key, figure, _state in _FIGURE_TEMPLATES.values():
        plt.close(figure)
    _FIGURE_TEMPLATES.clear()


def save_via_template(kind: str, key: tuple, build, update, output_path) -> None:
    """
    Render one PNG through a cached live figure.

    `build() -> (figure, state)` constructs the full figure for the current
    data (the ordinary plot function) and returns the artists update needs;
    `update(figure, state)` re-applies the current data to those artists.
    The live figure is cached per `kind`; a changed `key` (settings, sample
    rate, channel count — anything layout-affecting) or an update failure
    closes it and rebuilds fresh.
    """
    target = Path(output_path)
    target.parent.mkdir(parents=True, exist_ok=True)
    if FIGURE_TEMPLATES_ENABLED:
        entry = _FIGURE_TEMPLATES.get(kind)
        if entry is not None and entry[0] == key and plt.fignum_exists(entry[1].number):
            figure, state = entry[1], entry[2]
            try:
                update(figure, state)
                _save_tight(figure, target)
                return
            except Exception:
                _FIGURE_TEMPLATES.pop(kind, None)
                plt.close(figure)
    figure, state = build()
    if FIGURE_TEMPLATES_ENABLED:
        old = _FIGURE_TEMPLATES.pop(kind, None)
        if old is not None:
            plt.close(old[1])
        _FIGURE_TEMPLATES[kind] = (key, figure, state)
        _save_tight(figure, target)
    else:
        try:
            _save_tight(figure, target)
        finally:
            plt.close(figure)


def _build_line_figure(title, line_list, text_list, legend_kwargs, setup, build_extras):
    figure, axis = create_figure_and_axis(title=title)
    artists = [axis.plot(x, y, **props)[0] for x, y, props in line_list]
    text_artists = [axis.text(x, y, s, **props) for x, y, s, props in text_list]
    if build_extras is not None:
        build_extras(axis)  # static artists (axhlines, ...): added once
    if legend_kwargs is not None:
        axis.legend(**legend_kwargs)
    if setup is not None:
        setup(axis)
    return figure, axis, {"axis": axis, "lines": artists, "texts": text_artists}


def render_line_figure(
    kind: str,
    key: tuple,
    title: str,
    lines,
    output_path,
    show_interactive: bool,
    texts=(),
    legend_kwargs: Optional[dict] = None,
    setup=None,
    build_extras=None,
) -> None:
    """
    The one entry point for "N lines on one axes" figures: template-cached
    PNG save when writing to disk, ordinary fresh figure otherwise
    (interactive show, or no output path). `build_extras(axis)` adds static
    artists (axhlines, ...) once per built figure.
    """
    if output_path is not None and not show_interactive:
        save_lines_via_template(
            kind, key, output_path, title, lines,
            texts=texts, legend_kwargs=legend_kwargs, setup=setup,
            build_extras=build_extras,
        )
        return
    figure, _axis, _state = _build_line_figure(
        title, list(lines), list(texts), legend_kwargs, setup, build_extras
    )
    finalize_and_show_or_save(figure, output_path, show_interactive)


def save_lines_via_template(
    kind: str,
    key: tuple,
    output_path,
    title: str,
    lines,
    texts=(),
    legend_kwargs: Optional[dict] = None,
    setup=None,
    build_extras=None,
) -> None:
    """
    Template-cached renderer for the common "N lines on one axes" figure.

    `lines`: sequence of (x, y, props) with `props` a dict of static Line2D
    kwargs (label, alpha, linestyle, ...). `texts`: sequence of
    (x, y, string, props) drawn in data coordinates. `setup(axis)` applies
    the static axis config (labels, scales, limits) and is re-run on every
    update, AFTER autoscaling, so explicit limits win exactly as they do on
    the fresh path. `key` must cover everything that changes artist
    structure or static appearance: the per-line props, line/text counts,
    scales, settings. Title, data and text strings are volatile.

    Byte-identity with the fresh path holds because update reproduces the
    fresh sequence: same artists in the same order, autoscale from the same
    data limits, then the same static config.
    """
    line_list = list(lines)
    text_list = list(texts)
    # line labels are volatile (per-tap metrics ride in legend labels);
    # everything else about the props is structural
    props_key = (
        tuple(
            tuple(sorted((k, v) for k, v in p.items() if k != "label"))
            + (("has_label", "label" in p),)
            for _x, _y, p in line_list
        ),
        tuple(tuple(sorted(p.items())) for _x, _y, _s, p in text_list),
        None if legend_kwargs is None else tuple(sorted(legend_kwargs.items())),
    )
    full_key = (key, props_key)

    def build():
        figure, axis, state = _build_line_figure(
            title, line_list, text_list, legend_kwargs, setup, build_extras
        )
        return figure, state

    def update(figure, state):
        axis = state["axis"]
        if len(state["lines"]) != len(line_list) or len(state["texts"]) != len(
            text_list
        ):
            raise RuntimeError("artist count changed")  # -> rebuild fresh
        relabeled = False
        for artist, (x, y, props) in zip(state["lines"], line_list):
            artist.set_data(x, y)
            if "label" in props and artist.get_label() != props["label"]:
                artist.set_label(props["label"])
                relabeled = True
        for artist, (x, y, s, _props) in zip(state["texts"], text_list):
            artist.set_position((x, y))
            artist.set_text(s)
        axis.autoscale(True)
        axis.relim()
        axis.autoscale_view()
        if legend_kwargs is not None and relabeled:
            axis.legend(**legend_kwargs)
        if setup is not None:
            setup(axis)
        axis.set_title(title)

    save_via_template(kind, full_key, build, update, output_path)


def finalize_and_show_or_save(
    figure: plt.Figure,
    output_path: Optional[str | Path] = None,
    show_interactive: bool = True,
) -> None:
    """
    Dispose of a finished figure: PNG to `output_path` when given (parent
    dirs created, tight bounding box), else an interactive window when
    requested. The figure is always closed afterwards so long report runs
    never accumulate matplotlib state.
    """
    try:
        if output_path is not None:
            target = Path(output_path)
            target.parent.mkdir(parents=True, exist_ok=True)
            _save_tight(figure, target)
        elif show_interactive:
            plt.show()
    finally:
        plt.close(figure)


def label_time_axis_seconds(axis: plt.Axes) -> None:
    axis.set_xlabel("Time (seconds)")


def label_frequency_axis_hz(axis: plt.Axes, log_scale: bool = False) -> None:
    axis.set_xlabel("Frequency (Hz)")
    if log_scale:
        axis.set_xscale("log")


def label_amplitude_axis(axis: plt.Axes, unit: str = "Amplitude") -> None:
    axis.set_ylabel(unit)


def label_decibel_axis(axis: plt.Axes) -> None:
    axis.set_ylabel("Level (dB)")


def hz_tick_formatter(x, pos=None) -> str:
    if x >= 1000.0:
        return f"{int(round(x / 1000.0))}k"
    return f"{int(round(x))}"


def hz_major_ticks(f_min_hz: float, f_max_hz: float) -> List[float]:
    ticks = [20, 50, 100, 200, 500, 1000, 2000, 5000, 10000, 20000]
    out = [float(t) for t in ticks if f_min_hz <= float(t) <= f_max_hz]
    if not out:
        out = [float(max(1.0, f_min_hz)), float(f_max_hz)]
    return out


def apply_log_hz_xaxis(axis: plt.Axes, f_min_hz: float, f_max_hz: float) -> None:
    axis.set_xscale("log")
    axis.set_xlim(f_min_hz, f_max_hz)
    axis.set_xticks(hz_major_ticks(f_min_hz, f_max_hz))
    axis.xaxis.set_major_formatter(mticker.FuncFormatter(hz_tick_formatter))
    # No minor ticks at all: the explicit Hz majors carry the scale, and the
    # LogLocator's ~50 minor Tick objects are a measurable share of figure
    # build time (each Tick constructs lines+markers+text machinery).
    axis.xaxis.set_minor_locator(mticker.NullLocator())


def apply_log_hz_yaxis(axis: plt.Axes) -> None:
    axis.set_yticks(hz_major_ticks(20, 20000))
    axis.yaxis.set_major_formatter(mticker.FuncFormatter(hz_tick_formatter))
    axis.yaxis.set_minor_locator(mticker.NullLocator())


def time_axis_from_sample_count(number_of_samples: int, sample_rate_hz: int) -> np.ndarray:
    return np.arange(number_of_samples, dtype=np.float32) / float(sample_rate_hz)


# ----------------------------------------------------------------------------
# display decimation — rendering cost must scale with PIXELS, not samples.
#
# Reports plot million-sample curves (EDC, IR, 500k-bin spectra); Agg pays
# per vertex, so a 10x6in @100dpi figure was spending tens of seconds
# rasterising detail far below one pixel. Min-max envelope decimation is the
# standard visually-lossless waveform downsampling: per display bucket keep
# (min, max), so every pixel column still spans the exact same y-range the
# full-resolution line would have covered.
#
# max_points default: a 10in @100dpi axes is ~820 px wide, so ~840 buckets
# (1680 vertices) is one (min, max) pair per pixel column — the decimation
# is still exact at display resolution, and Agg strokes each column's
# vertical span once instead of the ~2.5x overdraw the old 4096-point
# default paid (noisy-spectrum FR draw measured 136 -> 85 ms/figure).
# ----------------------------------------------------------------------------

DISPLAY_DECIMATION_MAX_POINTS = 1680


def decimate_minmax(
    x: np.ndarray, y: np.ndarray, max_points: int = DISPLAY_DECIMATION_MAX_POINTS
) -> Tuple[np.ndarray, np.ndarray]:
    """Linear-x min-max envelope decimation to <= ~max_points vertices."""
    n = int(y.size)
    buckets = max(8, max_points // 2)
    if n <= 2 * buckets:
        return x, y
    k = n // buckets
    nb = n // k
    yb = y[: nb * k].reshape(nb, k)
    lo = yb.min(axis=1)
    hi = yb.max(axis=1)
    xb = x[: nb * k].reshape(nb, k)
    xm = xb[:, k // 2]
    out_x = np.repeat(xm, 2)
    out_y = np.empty(2 * nb, dtype=y.dtype)
    out_y[0::2] = lo
    out_y[1::2] = hi
    if nb * k < n:  # keep the exact tail endpoint
        out_x = np.append(out_x, x[-1])
        out_y = np.append(out_y, y[-1])
    return out_x, out_y


def decimate_minmax_log(
    f: np.ndarray,
    y: np.ndarray,
    f_min: float,
    f_max: float,
    max_points: int = DISPLAY_DECIMATION_MAX_POINTS,
) -> Tuple[np.ndarray, np.ndarray]:
    """
    Min-max decimation with log-spaced buckets, for log-x spectra: bucket
    density matches the log display so low frequencies keep full detail.
    Points below f_min/above f_max are dropped (they are off-axis anyway).
    """
    sel = (f >= max(1e-9, f_min)) & (f <= f_max)
    f_sel, y_sel = f[sel], y[sel]
    n = int(y_sel.size)
    buckets = max(8, max_points // 2)
    if n <= 2 * buckets:
        return f_sel, y_sel
    edges = np.logspace(np.log10(max(1e-9, f_min)), np.log10(f_max), buckets + 1)
    idx = np.searchsorted(f_sel, edges)
    lo_i, hi_i = idx[:-1], idx[1:]
    valid = hi_i > lo_i
    starts = lo_i[valid]
    ends = hi_i[valid]
    # non-empty buckets tile [starts[0], ends[-1]) contiguously (an empty
    # bucket leaves idx unchanged), so ufunc.reduceat over the start offsets
    # computes each bucket's min/max in one C pass — the per-bucket Python
    # loop this replaces was ~19 ms per 500k-bin spectrum
    span = y_sel[int(starts[0]) : int(ends[-1])]
    offsets = starts - starts[0]
    lo_v = np.minimum.reduceat(span, offsets)
    hi_v = np.maximum.reduceat(span, offsets)
    out_x = np.empty(2 * starts.size, f.dtype)
    out_x[0::2] = f_sel[starts]
    out_x[1::2] = f_sel[ends - 1]
    out_y = np.empty(2 * starts.size, y.dtype)
    out_y[0::2] = lo_v
    out_y[1::2] = hi_v
    return out_x, out_y


def log_frequency_image(
    mag_fb_t: np.ndarray,
    freq_hz: np.ndarray,
    f_min: float,
    f_max: float,
    rows: int = 720,
    cols: int = 1200,
) -> Tuple[np.ndarray, np.ndarray]:
    """
    Resample an (F, T) magnitude plane onto `rows` uniform log10(f) rows by
    max-pooling each row's source-bin range (peaks survive). Returns
    (image (rows, T'), row_edges_log10 (rows+1,)). Rendering the result with
    imshow on a log10(f) axis costs O(pixels) where a log-y pcolormesh pays
    per source quad (~4M for a 2^20-sample tap — tens of seconds on Agg).

    Columns are likewise max-pooled to <= ~cols when T exceeds the display
    width (a 10in @100dpi axes is ~820 px): imshow's rgba conversion pays
    per source pixel, and max-pooling keeps every transient visible.
    """
    t = mag_fb_t.shape[1]
    if cols > 0 and t > cols + cols // 2:
        k = -(-t // cols)  # ceil
        nb = -(-t // k)
        pad = nb * k - t
        if pad:
            mag_fb_t = np.concatenate(
                [mag_fb_t, np.full((mag_fb_t.shape[0], pad), -np.inf, np.float32)], axis=1
            )
        mag_fb_t = mag_fb_t.reshape(mag_fb_t.shape[0], nb, k).max(axis=2)

    log_lo, log_hi = np.log10(f_min), np.log10(f_max)
    edges = np.logspace(log_lo, log_hi, rows + 1)
    n_bins = mag_fb_t.shape[0]
    idx = np.searchsorted(freq_hz, edges).clip(0, n_bins)
    image = np.empty((rows, mag_fb_t.shape[1]), dtype=np.float32)
    for r in range(rows):
        lo_i, hi_i = int(idx[r]), int(idx[r + 1])
        if hi_i <= lo_i:
            # sub-bin row (low frequencies): nearest source bin
            image[r] = mag_fb_t[min(lo_i, n_bins - 1)]
        else:
            image[r] = mag_fb_t[lo_i:hi_i].max(axis=0)
    return image, np.log10(edges)


# ---------------------------------------------------------------------------
# Reference-compatible drawing helpers (the reference's plotting.py:106-217),
# as in audio_analysis_tpu/plot: external scripts built on the reference's
# plotting API call them directly. No analysis or report calls them (those
# draw through the house-style paths above); these stay simple on purpose.
# ---------------------------------------------------------------------------


def plot_time_series(
    axis,
    time_seconds: np.ndarray,
    samples: np.ndarray,
    label: Optional[str] = None,
    color: Optional[str] = None,
    alpha: float = 1.0,
) -> None:
    """Line plot of samples over time; adds a legend when labelled."""
    axis.plot(time_seconds, samples, label=label, color=color, alpha=alpha)
    if label is not None:
        axis.legend(loc="best")


def plot_log_magnitude_over_time(
    axis,
    time_seconds: np.ndarray,
    magnitude: np.ndarray,
    floor_db: float = -120.0,
    alpha: float = 1.0,
    label: Optional[str] = None,
) -> None:
    """Magnitude in dB over time, floored at floor_db."""
    floored = np.maximum(np.asarray(magnitude), 10.0 ** (floor_db / 20.0))
    axis.plot(time_seconds, 20.0 * np.log10(floored), alpha=alpha, label=label)
    axis.set_ylim(bottom=floor_db)


def plot_spectrogram(
    axis,
    spectrogram_magnitude: np.ndarray,
    time_seconds: np.ndarray,
    frequency_hz: np.ndarray,
    magnitude_floor_db: float = -120.0,
) -> None:
    """Log-magnitude spectrogram via pcolormesh on a log-frequency axis."""
    floor_lin = 10.0 ** (magnitude_floor_db / 20.0)
    level_db = 20.0 * np.log10(np.maximum(np.asarray(spectrogram_magnitude), floor_lin))
    mesh = axis.pcolormesh(
        time_seconds, frequency_hz, level_db, shading="nearest", cmap="magma"
    )
    axis.set_ylabel("Frequency (Hz)")
    axis.set_ylim(bottom=frequency_hz[1])
    axis.set_yscale("log")
    plt.colorbar(mesh, ax=axis, label="Magnitude (dB)")


def plot_waterfall_lines(
    axis,
    frequency_hz: np.ndarray,
    magnitude_slices: np.ndarray,
    time_offsets: np.ndarray,
    offset_scale: float = 1.0,
) -> None:
    """Stacked spectral slices (CSD-style), each offset by its time."""
    for s in range(np.asarray(magnitude_slices).shape[0]):
        axis.plot(
            frequency_hz,
            magnitude_slices[s] + time_offsets[s] * offset_scale,
            linewidth=1.0,
        )
    axis.set_xscale("log")
    axis.set_xlabel("Frequency (Hz)")
    axis.set_ylabel("Magnitude + time offset")


def plot_scatter(
    axis,
    x_values: np.ndarray,
    y_values: np.ndarray,
    size_values: Optional[np.ndarray] = None,
    alpha: float = 0.7,
) -> None:
    """Generic scatter helper (mode clouds)."""
    if size_values is None:
        axis.scatter(x_values, y_values, alpha=alpha)
    else:
        axis.scatter(x_values, y_values, s=size_values, alpha=alpha)
    axis.grid(True)
