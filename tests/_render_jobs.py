"""Recorded render jobs of a report: a plot worker that keeps the jobs
instead of running them, and the flattening and comparison of their
arguments (numpy only; tests and chip_smoke.py use it on either package)."""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path

import numpy as np


class RecordingPlotWorker:
    """The submit / drain contract of the plot workers; every job is kept,
    none is run (no figure is drawn, matplotlib is not needed)."""

    def __init__(self):
        self.jobs = []

    def submit(self, job, label=None):
        self.jobs.append(job)

    def drain(self):
        pass

    def drain_collect(self):
        return []

    def timings_by_kind(self):
        return {}

    def close(self):
        pass


def job_name(job) -> str:
    fn = job
    while isinstance(fn, functools.partial):
        fn = fn.func
    return fn.__name__


def leaves(value, prefix: str = "") -> dict:
    """{path: leaf} of a job's arguments: dataclass fields, sequence items
    and dict entries walked down to arrays, numbers, strings, paths."""
    if isinstance(value, functools.partial):
        out = leaves(list(value.args), prefix + "args")
        out.update(leaves(dict(value.keywords), prefix + "kw"))
        return out
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        out = {prefix + ".<type>": type(value).__name__}
        for f in dataclasses.fields(value):
            out.update(leaves(getattr(value, f.name), f"{prefix}.{f.name}"))
        return out
    if isinstance(value, (list, tuple)):
        out = {prefix + ".<len>": len(value)}
        for i, item in enumerate(value):
            out.update(leaves(item, f"{prefix}[{i}]"))
        return out
    if isinstance(value, dict):
        out = {prefix + ".<keys>": tuple(sorted(value))}
        for k in sorted(value):
            out.update(leaves(value[k], f"{prefix}[{k!r}]"))
        return out
    return {prefix: value}


# (rel, abs) of each render job's numbers, |a - b| <= max(abs, rel *
# max(|a|, |b|)): the per-module summary tolerances of
# tests/test_reference_parity.py (TOLERANCES); the dB arrays that crossed
# as the 1/128-dB fixed point also pass within two of its steps. Group
# delay is -dphase/dw bin by bin, ill-conditioned at the bins next to a
# near-zero of the spectrum: up to 0.1% of its bins may lie within twice
# the tolerance instead (two FFT implementations put 3 of 27,279 golden-IR
# bins at 1.02 times it).
JOB_TOLERANCES = {
    "plot_ir_from_wav_file": (0.0, 0.0),
    "render_decay_plots": (1e-3, 1e-3),
    "render_rt60_bands_plots": (1e-3, 2e-3),
    "render_frequency_response_plots": (5e-3, 1.0),
    "render_group_delay_plots": (2e-2, 5.0),
    "render_spectrogram_plots": (1e-3, 0.5),
    "render_waterfall_plots": (1e-3, 0.5),
    "render_diffusion_plots": (2e-2, 0.02),
    "render_modal_cloud_plots": (1e-2, 2e-3),
}
DB_STEP = 1.0 / 128.0
_DB_LEAVES = ("edc_db", "magnitude_db", "image", "slice_magnitude_rel_db")
_GD_OUTLIER_SHARE, _GD_OUTLIER_RATIO = 1e-3, 2.0


def _ratios(a, b, rel: float, abs_: float) -> np.ndarray:
    """|a - b| / max(abs, rel max(|a|, |b|)) per element (<= 1 within the
    tolerance); NaN against NaN agrees."""
    a = np.asarray(a, np.complex128 if np.iscomplexobj(a) else np.float64)
    b = np.asarray(b, a.dtype)
    both_nan = np.isnan(a) & np.isnan(b)
    d = np.where(both_nan, 0.0, np.abs(a - b))
    tol = np.maximum(abs_, rel * np.maximum(np.abs(a), np.abs(b)))
    ratio = np.where(d == 0, 0.0, d / np.where(tol > 0, tol, np.inf))
    return np.where(np.isnan(ratio) | ((tol == 0) & (d > 0)), np.inf, ratio).reshape(-1)


def _excess(a, b, rel: float, abs_: float, key: str = "") -> float:
    """The worst ratio to the tolerance (<= 1 agrees); for group delay the
    ratio of all but its outlier share, inf if an outlier exceeds its
    allowance."""
    ratio = _ratios(a, b, rel, abs_)
    if not ratio.size:
        return 0.0
    if key.endswith("group_delay_samples"):
        if ratio.max() > _GD_OUTLIER_RATIO:
            return float("inf")
        return float(np.quantile(ratio, 1.0 - _GD_OUTLIER_SHARE))
    return float(ratio.max())


def compare_jobs(ref_jobs, got_jobs) -> dict:
    """Each job of `got_jobs` against the one of `ref_jobs` at its index:
    the same render function, the same argument structure, strings, ints
    and flags equal, paths equal by name, numbers and arrays within the
    function's JOB_TOLERANCES. Returns {"<i> <function>": worst ratio to
    the tolerance}; raises AssertionError on the first disagreement."""
    if [job_name(j) for j in got_jobs] != [job_name(j) for j in ref_jobs]:
        raise AssertionError(f"render jobs differ: {[job_name(j) for j in got_jobs]} vs {[job_name(j) for j in ref_jobs]}")
    worst = {}
    for i, (ref, got) in enumerate(zip(ref_jobs, got_jobs)):
        name = job_name(ref)
        rel, abs_ = JOB_TOLERANCES[name]
        lr, lg = leaves(ref), leaves(got)
        if list(lr) != list(lg):
            raise AssertionError(f"{name}: argument structure differs: {sorted(set(lr) ^ set(lg))}")
        worst_job = 0.0
        for key, x in lr.items():
            y = lg[key]
            where = f"{name} {key}"
            if isinstance(x, Path) or isinstance(y, Path):
                if Path(x).name != Path(y).name:
                    raise AssertionError(f"{where}: {x} vs {y}")
            elif isinstance(x, np.ndarray):
                if not isinstance(y, np.ndarray) or x.shape != y.shape:
                    raise AssertionError(f"{where}: array shape {getattr(y, 'shape', y)} vs {x.shape}")
                if x.dtype.kind in "fc":
                    leaf_abs = max(abs_, 2 * DB_STEP) if key.endswith(_DB_LEAVES) else abs_
                    ratio = _excess(x, y, rel, leaf_abs, key)
                    if ratio > 1.0:
                        raise AssertionError(f"{where}: beyond (rel {rel}, abs {leaf_abs}): ratio {ratio:.3g}")
                    worst_job = max(worst_job, ratio)
                elif not np.array_equal(x, y):
                    raise AssertionError(f"{where}: {y} vs {x}")
            elif isinstance(x, float) and not isinstance(x, bool):
                ratio = _excess(x, y, rel, abs_)
                if ratio > 1.0:
                    raise AssertionError(f"{where}: {y} vs {x} beyond (rel {rel}, abs {abs_})")
                worst_job = max(worst_job, ratio)
            elif x != y and not (x is None and y is None):
                raise AssertionError(f"{where}: {y!r} vs {x!r}")
        worst[f"{i} {name}"] = worst_job
    return worst


def write_environment(path, keys) -> None:
    """A render-shaped job for the process pool tests: the named variables
    of the running process's environment, as JSON, to `path`."""
    import json
    import os

    Path(path).write_text(json.dumps({key: os.environ.get(key) for key in keys}))
