"""
Waterfall (cumulative-spectral-decay style) slices of the STFT
(audio_analysis_tpu/analyses/waterfall.py): slice modes auto /
uniform_time / uniform_frames, dB relative to the global or per-slice max
clipped to [-dyn, 0], optional per-slice log-frequency smoothing, the
summary, and one figure per channel `<basename>_waterfall_<CH>.png`: a 3D
surface over (log10 f, t, dB) with the time axis inverted (through a live
figure template), or 2D stacked ridges.

The dB plane is one call of kernel K2 through the file's memoised STFT;
only the selected frames are gathered on the device and fetched, in the
1/128-dB fixed point. The settings and the slice policy are the ones the
engine summaries use (report/waterfall.py). matplotlib is imported by the
figure functions only.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from audio_analysis_tpu_torch.analyses._common import FileDsp, single_channel_dsp, suffixed_png
from audio_analysis_tpu_torch.ops import display, logfreq, stft
from audio_analysis_tpu_torch.report.waterfall import (  # noqa: F401
    WaterfallAnalysisSettings,
    select_slice_frame_indices,
)


@dataclass(frozen=True)
class WaterfallPlotSettings:
    style: str = "3d"  # "3d" | "2d"
    secondary_channel_alpha: float = 0.7
    elev_deg: float = 30.0
    azim_deg: float = -60.0
    ridge_offset_db: float = 6.0
    zlim_db: Optional[Tuple[float, float]] = None


@dataclass(frozen=True)
class ChannelWaterfallResult:
    channel_name: str
    sample_rate_hz: int
    analysis_start_sample_index: int
    analysis_length_samples: int
    slice_times_seconds: np.ndarray  # (S,)
    frequency_hz: np.ndarray  # (F,)
    slice_magnitude_rel_db: np.ndarray  # (S, F) in [-dyn, 0]


def _build_rel_db_slices_from(
    slices_db: np.ndarray,
    frame_idx: np.ndarray,
    frame_times: np.ndarray,
    sample_rate_hz: int,
    settings: WaterfallAnalysisSettings,
    f_min: float,
    f_max: float,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(slice_times (S,), freq (F,), rel_db (S, F)) from the frequency-
    selected slices of one channel (host)."""
    if frame_idx.size < 2:
        raise ValueError("Not enough slices selected for waterfall (increase duration or num_slices).")

    freq_hz = stft.rfft_freqs_hz(settings.n_fft, sample_rate_hz)
    fmask = (freq_hz >= f_min) & (freq_hz <= f_max)
    if not np.any(fmask):
        raise ValueError("Waterfall frequency selection is empty (check f_min_hz/f_max_hz).")
    f_sel = freq_hz[fmask].astype(np.float32)
    slices_db = np.asarray(slices_db, np.float32)  # (S, F_sel)

    if settings.smoothing_log_bins and int(settings.smoothing_log_bins) > 1:
        slices_db = logfreq.smooth_mag_db_log_frequency(
            f_sel,
            torch.from_numpy(slices_db),
            f_min,
            f_max,
            int(settings.smoothing_log_bins),
            int(settings.log_bins_per_octave),
        ).numpy()

    if str(settings.db_reference).lower() == "slice_max":
        rel = slices_db - slices_db.max(axis=1, keepdims=True)
    else:
        rel = slices_db - float(slices_db.max())
    dyn = float(max(10.0, settings.dynamic_range_db))
    rel = np.clip(rel, -dyn, 0.0).astype(np.float32)
    return frame_times[frame_idx].astype(np.float32), f_sel, rel


def analyse_waterfall_channels(
    dsp: FileDsp,
    settings: WaterfallAnalysisSettings,
) -> List[ChannelWaterfallResult]:
    """All channels from the file's shared STFT (one kernel launch)."""
    starts, seg_lens = dsp.aligned_host_meta(
        settings.trim_to_peak, settings.ignore_leading_seconds, settings.analysis_duration_seconds
    )
    if int(seg_lens.min()) < settings.n_fft:
        raise ValueError("Not enough samples after trimming/selection for waterfall (need at least n_fft).")

    stft_dev = dsp.stft_db(
        settings.trim_to_peak,
        settings.ignore_leading_seconds,
        settings.analysis_duration_seconds,
        int(settings.n_fft),
        int(settings.hop_length),
        bool(settings.use_hann_window),
        float(settings.floor_db),
    )
    nyq = float(stft.rfft_freqs_hz(settings.n_fft, dsp.sample_rate_hz)[-1])
    f_min = float(np.clip(settings.f_min_hz, 1.0, nyq))
    f_max = float(np.clip(settings.f_max_hz, f_min, nyq))

    # each channel's slice frames, from its valid frame count (host meta)
    frames_per_ch = [
        stft.num_frames_static(int(l), int(settings.n_fft), int(settings.hop_length)) for l in seg_lens
    ]
    frame_times = [stft.frame_times_seconds(t, settings.hop_length, dsp.sample_rate_hz) for t in frames_per_ch]
    idx_per_ch = [select_slice_frame_indices(ft, settings) for ft in frame_times]
    idx_padded = np.zeros((len(idx_per_ch), max(ix.size for ix in idx_per_ch)), np.int32)
    for i, ix in enumerate(idx_per_ch):
        idx_padded[i, : ix.size] = ix
        idx_padded[i, ix.size :] = ix[-1] if ix.size else 0
    slices_host = display.stft_frame_slices(
        stft_dev.mag_db, idx_padded, int(settings.n_fft), dsp.sample_rate_hz, f_min, f_max
    )  # (C, S_max, F_sel)

    results = []
    for i, channel_name in enumerate(dsp.channel_names):
        slice_times, f_sel, rel = _build_rel_db_slices_from(
            slices_host[i][: idx_per_ch[i].size],
            idx_per_ch[i],
            frame_times[i],
            dsp.sample_rate_hz,
            settings,
            f_min,
            f_max,
        )
        results.append(
            ChannelWaterfallResult(
                channel_name=str(channel_name),
                sample_rate_hz=dsp.sample_rate_hz,
                analysis_start_sample_index=int(starts[i]),
                analysis_length_samples=int(seg_lens[i]),
                slice_times_seconds=slice_times,
                frequency_hz=f_sel,
                slice_magnitude_rel_db=rel,
            )
        )
    return results


def analyse_waterfall_for_channel(
    samples: np.ndarray,
    sample_rate_hz: int,
    channel_name: str,
    settings: WaterfallAnalysisSettings,
    device: "str | torch.device" = "cuda",
) -> ChannelWaterfallResult:
    return analyse_waterfall_channels(
        single_channel_dsp(samples, sample_rate_hz, channel_name, device), settings
    )[0]


def analyse_waterfall_from_wav_file(
    input_wav_file_path: str | Path,
    settings: Optional[WaterfallAnalysisSettings] = None,
    dsp: Optional[FileDsp] = None,
    device: "str | torch.device" = "cuda",
) -> List[ChannelWaterfallResult]:
    if settings is None:
        settings = WaterfallAnalysisSettings()
    if dsp is None:
        dsp = FileDsp.from_wav_file(input_wav_file_path, settings.use_mono_downmix_for_stereo, device)
    return analyse_waterfall_channels(dsp, settings)


def _pool_slices_log_f(
    frequency_hz: np.ndarray,
    slices_db: np.ndarray,
    f_min: float,
    f_max: float,
    buckets: int = 384,
) -> Tuple[np.ndarray, np.ndarray]:
    """
    Max-pool the (num_slices, F) ridge planes onto at most `buckets` log-f
    columns (peaks survive; 384 log buckets exceed what the log axis
    resolves). The input unchanged when it is already small.
    """
    n = int(frequency_hz.size)
    if n <= 2 * buckets:
        return frequency_hz, slices_db
    edges = np.logspace(np.log10(max(1e-9, f_min)), np.log10(f_max), buckets + 1)
    idx = np.searchsorted(frequency_hz, edges[:-1]).clip(0, n - 1)
    idx = np.unique(idx)  # duplicate bucket starts (sub-bin buckets at low f)
    return frequency_hz[idx], np.maximum.reduceat(slices_db, idx, axis=1)


def _band(result: ChannelWaterfallResult, analysis_settings: WaterfallAnalysisSettings) -> Tuple[float, float, float]:
    nyquist = 0.5 * float(result.sample_rate_hz)
    f_min = float(np.clip(analysis_settings.f_min_hz, 1.0, nyquist))
    f_max = float(np.clip(analysis_settings.f_max_hz, f_min, nyquist))
    return f_min, f_max, float(max(10.0, analysis_settings.dynamic_range_db))


def _draw_surface(axis, freq_hz: np.ndarray, times: np.ndarray, slices_db: np.ndarray):
    x_log = np.log10(freq_hz.astype(np.float64))
    mesh_x, mesh_y = np.meshgrid(x_log, times.astype(np.float64))
    return axis.plot_surface(
        mesh_x, mesh_y, slices_db.astype(np.float64),
        cmap="viridis", alpha=0.8, antialiased=True, edgecolor="none", linewidth=0,
    )


def plot_waterfall_figure(
    result: ChannelWaterfallResult,
    analysis_settings: WaterfallAnalysisSettings,
    plot_settings: WaterfallPlotSettings,
    title: Optional[str] = None,
):
    import matplotlib.pyplot as plt

    from audio_analysis_tpu_torch import plot

    style = str(plot_settings.style).lower()
    f_min, f_max, dyn = _band(result, analysis_settings)
    # the ~1700 STFT bins pooled onto log-f buckets (max keeps the peaks):
    # Agg pays per 3D quad and line vertex
    freq_hz, slices_db = _pool_slices_log_f(result.frequency_hz, result.slice_magnitude_rel_db, f_min, f_max)

    if style == "2d":
        figure, axis = plot.create_figure_and_axis(title=title)
        axis.set_xlabel("Frequency (Hz)")
        axis.set_ylabel("Magnitude (dB, offset by time slice)")
        plot.apply_log_hz_xaxis(axis, f_min, f_max)
        ridge_offset = float(max(0.0, plot_settings.ridge_offset_db))
        num_slices = int(result.slice_times_seconds.size)
        for i in range(num_slices):
            axis.plot(freq_hz, slices_db[i] - i * ridge_offset, alpha=0.9)
        for idx in (0, num_slices // 2, num_slices - 1):
            axis.text(
                float(freq_hz[0]),
                -float(idx) * ridge_offset,
                f"{float(result.slice_times_seconds[idx]):.2f}s",
                fontsize=9,
                verticalalignment="bottom",
            )
        axis.grid(True, which="both", linestyle=":", linewidth=0.5)
        if plot_settings.zlim_db is not None:
            axis.set_ylim(*plot_settings.zlim_db)
        else:
            axis.set_ylim(-(num_slices - 1) * ridge_offset - dyn, 2.0)
        return figure

    # 3D surface: X = log10(f) (mplot3d log axes are unreliable), labelled in Hz
    figure = plt.figure(figsize=plot.DEFAULT_FIGURE_SIZE, dpi=plot.DEFAULT_DPI)
    axis = figure.add_subplot(111, projection="3d")
    if title:
        axis.set_title(title)
    _draw_surface(axis, freq_hz, result.slice_times_seconds, slices_db)
    axis.set_xlabel("Frequency (Hz)")
    axis.set_ylabel("Time (s)")
    axis.set_zlabel("Magnitude (dB rel)")
    axis.invert_yaxis()  # earliest time furthest away
    ticks_hz = plot.hz_major_ticks(f_min, f_max)
    axis.set_xlim(np.log10(f_min), np.log10(f_max))
    axis.set_xticks([np.log10(t) for t in ticks_hz])
    axis.set_xticklabels([plot.hz_tick_formatter(t) for t in ticks_hz])
    if plot_settings.zlim_db is not None:
        axis.set_zlim(*plot_settings.zlim_db)
    else:
        axis.set_zlim(-dyn, 2.0)
    axis.view_init(elev=float(plot_settings.elev_deg), azim=float(plot_settings.azim_deg))
    return figure


def plot_waterfall_from_wav_file(
    input_wav_file_path: str | Path,
    analysis_settings: Optional[WaterfallAnalysisSettings] = None,
    plot_settings: Optional[WaterfallPlotSettings] = None,
    output_basename: Optional[str | Path] = None,
    show_interactive: bool = True,
    dsp: Optional[FileDsp] = None,
    device: "str | torch.device" = "cuda",
) -> List[ChannelWaterfallResult]:
    if analysis_settings is None:
        analysis_settings = WaterfallAnalysisSettings()
    if plot_settings is None:
        plot_settings = WaterfallPlotSettings()
    results = analyse_waterfall_from_wav_file(input_wav_file_path, analysis_settings, dsp=dsp, device=device)
    render_waterfall_plots(
        results, analysis_settings, plot_settings, output_basename, show_interactive, input_wav_file_path
    )
    return results


def render_waterfall_plots(
    results: List[ChannelWaterfallResult],
    analysis_settings: WaterfallAnalysisSettings,
    plot_settings: WaterfallPlotSettings,
    output_basename: Optional[str | Path],
    show_interactive: bool,
    title_source: str | Path,
) -> None:
    """Figures and save only (host matplotlib); results come from analyse_*.
    The "3d" style renders through a live figure template: only the
    surface collection is replaced per figure."""
    from audio_analysis_tpu_torch import plot

    for r in results:
        title = f"Waterfall — {title_source} — {r.channel_name}"
        output_path = None if output_basename is None else suffixed_png(output_basename, f"_waterfall_{r.channel_name}")
        use_template = output_path is not None and not show_interactive and str(plot_settings.style).lower() == "3d"
        if not use_template:
            fig = plot_waterfall_figure(r, analysis_settings, plot_settings, title)
            plot.finalize_and_show_or_save(fig, output_path, show_interactive)
            continue

        def build(r=r, title=title):
            fig = plot_waterfall_figure(r, analysis_settings, plot_settings, title)
            axis = fig.axes[0]
            return fig, {"axis": axis, "surface": axis.collections[0]}

        def update(fig, state, r=r, title=title):
            _update_waterfall_3d_figure(fig, state, r, analysis_settings, plot_settings, title)

        plot.save_via_template(
            kind="waterfall3d",
            key=(analysis_settings, plot_settings, int(r.sample_rate_hz)),
            build=build,
            update=update,
            output_path=output_path,
        )


def _update_waterfall_3d_figure(
    figure,
    state: dict,
    result: ChannelWaterfallResult,
    analysis_settings: WaterfallAnalysisSettings,
    plot_settings: WaterfallPlotSettings,
    title: str,
) -> None:
    """Replace the surface of a live 3D waterfall figure and re-apply the
    data path of plot_waterfall_figure ("3d" style)."""
    import matplotlib.transforms as mtransforms

    from audio_analysis_tpu_torch import plot

    axis = state["axis"]
    f_min, f_max, dyn = _band(result, analysis_settings)
    freq_hz, slices_db = _pool_slices_log_f(result.frequency_hz, result.slice_magnitude_rel_db, f_min, f_max)
    state["surface"].remove()
    # mplot3d unions new data into stale limits; reset before re-adding
    axis.xy_dataLim = mtransforms.Bbox.null()
    axis.zz_dataLim = mtransforms.Bbox.null()
    state["surface"] = _draw_surface(axis, freq_hz, result.slice_times_seconds, slices_db)
    # the same static configuration as the fresh build (idempotent)
    axis.set_xlabel("Frequency (Hz)")
    axis.set_ylabel("Time (s)")
    axis.set_zlabel("Magnitude (dB rel)")
    if not axis.yaxis_inverted():
        axis.invert_yaxis()
    ticks_hz = plot.hz_major_ticks(f_min, f_max)
    axis.set_xlim(np.log10(f_min), np.log10(f_max))
    axis.set_xticks([np.log10(t) for t in ticks_hz])
    axis.set_xticklabels([plot.hz_tick_formatter(t) for t in ticks_hz])
    if plot_settings.zlim_db is not None:
        axis.set_zlim(*plot_settings.zlim_db)
    else:
        axis.set_zlim(-dyn, 2.0)
    axis.view_init(elev=float(plot_settings.elev_deg), azim=float(plot_settings.azim_deg))
    axis.set_title(title)


def summarise_waterfall_results_text(results: List[ChannelWaterfallResult]) -> str:
    lines = []
    for r in results:
        dur = float(r.analysis_length_samples) / float(r.sample_rate_hz)
        lines.append(
            f"[{r.channel_name}] start_sample={r.analysis_start_sample_index}  dur={dur:.3f}s  "
            f"slices={int(r.slice_times_seconds.size)}  f_bins={int(r.frequency_hz.size)}"
        )
    return "\n".join(lines)
