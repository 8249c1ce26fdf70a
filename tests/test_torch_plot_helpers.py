"""The port's reference-compatible figure helpers (plot_time_series,
plot_log_magnitude_over_time, plot_spectrogram, plot_waterfall_lines and
plot_scatter in audio_analysis_tpu_torch/plot) against the JAX package's
(audio_analysis_tpu/plot), on Agg figures, on the CPU.

- Each helper draws the same seeded inputs through both packages, each on
  a fresh figure; the artists must be equal, exactly: every line's
  `get_xydata()`, colour, alpha, width and label; the mesh's `get_array()`,
  colormap name and colour limits; the scatter's offsets, sizes and alpha;
  the axes' scales, limits and labels; the legend texts; the figure's axes
  count and their labels (the spectrogram's colorbar).
- The port's plot/__init__.py defines every public top-level name of the
  JAX package's (an `ast` check).
"""

import ast
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("matplotlib")

from audio_analysis_tpu import plot as jax_plot  # noqa: E402
from audio_analysis_tpu_torch import plot as port_plot  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
plt = port_plot.plt


def _inputs(case: str):
    """(helper name, positional args, keyword args) of one case, from a
    seed."""
    rng = np.random.default_rng(sum(map(ord, case)))
    t = np.arange(600) / 48_000.0
    x = (rng.standard_normal(600) * np.exp(-t / 0.003)).astype(np.float32)
    if case == "time_series":
        return "plot_time_series", (t, x), {"label": "left", "color": "C3", "alpha": 0.6}
    if case == "time_series_unlabelled":
        return "plot_time_series", (t, x), {}
    if case == "log_magnitude":
        return "plot_log_magnitude_over_time", (t, np.abs(x)), {"floor_db": -90.0, "alpha": 0.8, "label": "mag"}
    if case == "log_magnitude_default_floor":
        return "plot_log_magnitude_over_time", (t, np.abs(x)), {}
    if case == "spectrogram":
        freq = np.linspace(0.0, 24_000.0, 65)
        times = np.arange(12) * 0.01
        mag = np.abs(rng.standard_normal((65, 12))) * 10.0 ** rng.uniform(-8, 0, (65, 1))
        return "plot_spectrogram", (mag, times, freq), {"magnitude_floor_db": -100.0}
    if case == "waterfall":
        freq = np.geomspace(20.0, 20_000.0, 200)
        slices = -np.abs(rng.standard_normal((6, 200))) * 20.0
        return "plot_waterfall_lines", (freq, slices, np.arange(6) * 0.05), {"offset_scale": 40.0}
    if case == "scatter":
        return "plot_scatter", (rng.uniform(20, 20_000, 40), rng.uniform(0.1, 2.0, 40)), {}
    if case == "scatter_sized":
        return "plot_scatter", (rng.uniform(20, 20_000, 40), rng.uniform(0.1, 2.0, 40),
                                rng.uniform(5, 60, 40)), {"alpha": 0.4}
    raise KeyError(case)


CASES = ["time_series", "time_series_unlabelled", "log_magnitude", "log_magnitude_default_floor", "spectrogram",
         "waterfall", "scatter", "scatter_sized"]


def _artists(fig) -> list:
    """Everything the helpers set, per axes of the figure, as plain values."""
    out = []
    for ax in fig.axes:
        legend = ax.get_legend()
        entry = {
            "scales": (ax.get_xscale(), ax.get_yscale()),
            "limits": (ax.get_xlim(), ax.get_ylim()),
            "labels": (ax.get_xlabel(), ax.get_ylabel(), ax.get_title()),
            "legend": None if legend is None else [t.get_text() for t in legend.get_texts()],
            "grid": any(line.get_visible() for line in ax.get_xgridlines() + ax.get_ygridlines()),
            "lines": [(line.get_xydata(), line.get_color(), line.get_alpha(), line.get_linewidth(), line.get_label())
                      for line in ax.get_lines()],
            "collections": [],
        }
        for coll in ax.collections:
            item = {"type": type(coll).__name__, "alpha": coll.get_alpha(), "cmap": coll.get_cmap().name}
            if hasattr(coll, "get_offsets"):
                item["offsets"] = np.asarray(coll.get_offsets())
            if hasattr(coll, "get_sizes"):
                item["sizes"] = np.asarray(coll.get_sizes())
            if coll.get_array() is not None:
                item["array"] = np.asarray(coll.get_array())
                item["clim"] = coll.get_clim()
            entry["collections"].append(item)
        out.append(entry)
    return out


def _assert_equal(a, b, where):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for key in a:
            _assert_equal(a[key], b[key], f"{where}.{key}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.shape == b.shape and a.dtype == b.dtype, where
        assert np.array_equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("case", CASES)
def test_helper_draws_the_jax_artists(case):
    name, args, kwargs = _inputs(case)
    figures = []
    for module in (jax_plot, port_plot):
        fig, ax = plt.subplots()
        getattr(module, name)(ax, *args, **kwargs)
        figures.append(fig)
    theirs, ours = (_artists(fig) for fig in figures)
    for fig in figures:
        plt.close(fig)
    _assert_equal(ours, theirs, case)
    assert ours[0]["lines"] or ours[0]["collections"]
    if name == "plot_spectrogram":
        assert ours[0]["collections"][0]["cmap"] == "magma" and len(ours) == 2  # the colorbar's axes


def _public_names(path: Path) -> set:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names.update(t.id for t in targets if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


def test_port_plot_has_every_public_name_of_the_jax_plot():
    theirs = _public_names(REPO / "audio_analysis_tpu" / "plot" / "__init__.py")
    ours = _public_names(REPO / "audio_analysis_tpu_torch" / "plot" / "__init__.py")
    assert {"plot_time_series", "plot_log_magnitude_over_time", "plot_spectrogram", "plot_waterfall_lines",
            "plot_scatter"} <= theirs
    assert theirs - ours == set()
