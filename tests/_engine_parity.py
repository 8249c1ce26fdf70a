"""Comparison of two runs of the fused engine (dicts of numpy arrays, the
outputs of `analyze_batch`), shared by tests/test_torch_fuzz_engine.py (the
port against the JAX package on the CPU) and chip_smoke.py's fuzz phase (K1
and K2 against their plain versions on the card). numpy only; checks raise
AssertionError explicitly, so they hold under `python -O` too.

Drawn settings reach places where no float32 result can be held to a
fixed tolerance: a dB crossing that falls within rounding of a sample
boundary moves a sample in or out of a fit, a count over a threshold
(echo density, a modal bin's reliability gate) flips, and a modal log bin
whose content lies 120 dB or more below its frame's peak is float32
rounding noise (in both packages and in both FFTs). So:

- integers and the geometry of the run (start_index, segment_length,
  peak_abs, the frame counts) are exact;
- every other output must agree within its tolerance plus CONDITIONING
  times its spread over the conditioning runs: the same run with noise at
  float32 round-off on every valid sample (2^-22 of each row's RMS, about
  one rounding of an N-point FFT, 2^-24 sqrt(log2 N)), and with every fit's
  dB targets moved by +-DB_SHIFT. A flag may differ only where the
  conditioning runs flip it;
- fit values are compared where the fit is valid (its *_ok flag set) in
  both runs: a fit that is not valid has no value in any report;
- per-bin modal fits: in each row at most max(2, 5%) of the reliable bins
  are reliable in one run only or differ by more than 1e-2; modal_count
  and the aggregates follow the run's own bins (its count of reliable
  bins; numpy's median, 90th percentile and max of its bins within 1e-5)
  and, where no bin of the row differs, equal the other run's (the count
  exactly, the aggregates within the bins' 1e-2).
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np

EXACT = {"start_index", "segment_length", "stft_num_frames", "diff_num_frames", "peak_abs"}
FITS = ("band_t30", "band_t20", "band_edt", "early10", "edt", "t20", "t30")
PERTURBATION_SEEDS = (101, 102)
DB_SHIFT = 0.1
CONDITIONING = 4.0
MODAL_BIN_RTOL = 1e-2


def shifted(cfg, db: float):
    """The engine config with every dB target of the fits moved by `db`."""

    def move(r):
        return (r[0] + db, r[1] + db)

    return dataclasses.replace(
        cfg, t20_range_db=move(cfg.t20_range_db), t30_range_db=move(cfg.t30_range_db),
        edt_range_db=move(cfg.edt_range_db), fit_lower_limit_db=cfg.fit_lower_limit_db + db,
    )


def perturbed(x: np.ndarray, lens: np.ndarray) -> list:
    """(B, C, N) float32 taps with noise at float32 round-off added to every
    valid sample, one array per seed; zero past each tap's length."""
    valid = np.arange(x.shape[-1]) < lens[:, None, None]
    power = np.sum(np.where(valid, x, 0.0).astype(np.float64) ** 2, axis=-1, keepdims=True)
    rms = np.sqrt(power / np.maximum(lens[:, None, None], 1))
    out = []
    for seed in PERTURBATION_SEEDS:
        noise = np.random.default_rng(seed).standard_normal(x.shape)
        out.append(np.where(valid, x + 2.0 ** -22 * rms * noise, 0.0).astype(np.float32))
    return out


def conditioning_runs(run, x: np.ndarray, lens: np.ndarray, cfg) -> list:
    """`run(x, lens, cfg)` on the perturbed taps and with the dB targets
    moved both ways."""
    return [run(xp, lens, cfg) for xp in perturbed(x, lens)] + [
        run(x, lens, shifted(cfg, db)) for db in (DB_SHIFT, -DB_SHIFT)
    ]


def spread(got: dict, runs: list, key: str) -> np.ndarray:
    """Elementwise largest move of `got[key]` over the conditioning runs (1
    where a flag flips, inf where a value turns NaN or back)."""
    a = got[key].astype(np.float64)
    out = np.zeros(a.shape)
    for r in runs:
        b = r[key].astype(np.float64)
        move = np.where(np.isnan(a) & np.isnan(b), 0.0, np.abs(a - b))
        out = np.maximum(out, np.where(np.isnan(move), np.inf, move))
    return out


def _fit_ok(key: str, ref: dict, got: dict):
    flag = next((f"{p}_ok" for p in FITS if key.startswith(p + "_") and not key.endswith("_ok")), None)
    return None if flag is None else ref[flag] & got[flag]


def _assert_within(key, a, b, sp, compared, rtol, atol, what):
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    diff = np.where(np.isnan(a64) & np.isnan(b64), 0.0, np.abs(a64 - b64))
    diff = np.where(np.isnan(diff), np.inf, diff)
    limit = atol + rtol * np.nan_to_num(np.abs(b64)) + CONDITIONING * sp
    bad = compared & ~(diff <= limit)
    if bad.any():
        at = tuple(int(i) for i in np.argwhere(bad)[0])
        raise AssertionError(
            f"{what}{key}: {int(bad.sum())} of {bad.size} outside the limit; at {at} {a[at]} vs {b[at]}, "
            f"spread over the conditioning runs {sp[at]}"
        )
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(compared & (diff > 0), diff / limit, 0.0)
    return float(ratio.max()) if ratio.size else 0.0


def assert_modal_bins_agree(ref: dict, got: dict, what: str = "") -> float:
    """The per-bin rules of the module docstring; returns the largest share
    of a row's allowed differing bins that is used."""
    a, b = got["modal_rt60"].astype(np.float64), ref["modal_rt60"].astype(np.float64)
    r2a, r2b = got["modal_r2"].astype(np.float64), ref["modal_r2"].astype(np.float64)
    both = np.isfinite(a) & np.isfinite(b)
    with np.errstate(invalid="ignore"):
        off = (np.isfinite(a) != np.isfinite(b)) | both & (
            (np.abs(a - b) > MODAL_BIN_RTOL * np.abs(b)) | (np.abs(r2a - r2b) > MODAL_BIN_RTOL * np.abs(r2b))
        )
    if not (np.array_equal(np.isfinite(a), np.isfinite(r2a))
            and np.array_equal(got["modal_count"], np.isfinite(a).sum(axis=-1))):
        raise AssertionError(f"{what}modal_count / modal_r2 do not follow the reliable bins of modal_rt60")
    allowed = np.maximum(2, 0.05 * np.maximum(np.isfinite(a).sum(axis=-1), np.isfinite(b).sum(axis=-1)))
    if np.any(off.sum(axis=-1) > allowed):
        row = tuple(int(i) for i in np.argwhere(off.sum(axis=-1) > allowed)[0])
        raise AssertionError(f"{what}modal bins: {int(off[row].sum())} of row {row} differ, allowed {allowed[row]}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        own = {
            "modal_median_rt60": np.nanmedian(a, axis=-1),
            "modal_p90_rt60": np.nanpercentile(a, 90.0, axis=-1),
            "modal_max_rt60": np.nanmax(a, axis=-1),
        }
    same = ~off.any(axis=-1)
    for key, value in own.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-5, equal_nan=True, err_msg=what + key + " (own bins)")
        np.testing.assert_allclose(got[key][same], ref[key][same], rtol=MODAL_BIN_RTOL, equal_nan=True,
                                   err_msg=what + key)
    np.testing.assert_array_equal(got["modal_count"][same], ref["modal_count"][same], err_msg=what + "modal_count")
    return float((off.sum(axis=-1) / allowed).max()) if off.size else 0.0


def assert_engines_agree(ref: dict, got: dict, runs: list, tolerance, gd_rows, what: str = "") -> float:
    """`got` (with its conditioning runs `runs`) against `ref`, every key
    but the modal ones within `tolerance(key)` = (rtol, atol); group delay
    only on the taps `gd_rows` marks. Returns the largest ratio of a
    difference to its limit (1 at the limit)."""
    worst = 0.0
    if sorted(got) != sorted(ref):
        raise AssertionError(f"{what}keys differ: {sorted(set(got) ^ set(ref))}")
    for key in ref:
        a, b = got[key], ref[key]
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{what}{key}: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
        if key in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=what + key)
            continue
        if key.startswith("modal_"):
            continue
        compared = np.ones(a.shape, bool)
        if key.startswith("gd_"):
            compared[~np.asarray(gd_rows, bool)] = False
        rtol, atol = (0.0, 0.0) if a.dtype == np.bool_ else tolerance(key)
        both_ok = _fit_ok(key, ref, got)
        if both_ok is not None:
            compared &= both_ok
        worst = max(worst, _assert_within(key, a, b, spread(got, runs, key), compared, rtol, atol, what))
    if "modal_rt60" in ref:
        worst = max(worst, assert_modal_bins_agree(ref, got, what))
    return worst
