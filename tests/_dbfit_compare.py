"""K5's decay fits (audio_analysis_tpu_torch/csrc/dbfit.cu) held to the plain
version, `dbfit.fit_decay_ranges_plain`, and to a float64 fit over the same
window: tests/test_torch_dbfit_host.py runs the kernel's source built for
the CPU, tests/test_torch_cuda.py the kernel on the card.

Crossing times, point counts and `ok` must be bit-equal: the kernel forms
the first two with the plain version's float32 operations, and `ok` from
them and the slope's sign, which the sums' rounding cannot flip on the
curves held here (EDCs, which do not increase, and edge and noise rows
whose windows are far from flat). Only the sums differ: the
kernel's run in float64, the plain version's in float32 (torch's reductions
of up to a million products a row). So the kernel's slope, intercept, r^2
and RT60 must lie within TOLERANCE of the plain version's, and within one
float32 rounding of the float64 fit (oracle.fit_decay_slope's formulas
over the plain version's window; RT60, -60 over the float32 slope, within
two; an intercept within 1e-12 dB), no farther from it than the plain version is but for that rounding.
"""

import numpy as np
import torch

EXACT = ("start_time_seconds", "end_time_seconds", "num_points", "ok")
# kernel against plain: relative for slope and RT60; absolute for r^2; for
# the intercept relative to the dB the fit spans, |slope| x end time, with
# 1e-5 dB beside it for fits that span nothing
TOLERANCE = {"slope_db_per_second": 1e-4, "rt60_seconds": 1e-4, "r_squared": 1e-5, "intercept_db": 1e-4}
SUMS = tuple(TOLERANCE)


def window_fit_f64(curve: np.ndarray, num: int, start: float, end: float, length: int, dt: float):
    """(slope, intercept, r2, rt60) of the float64 least-squares line over
    the points of one row that the plain version's window holds (i <
    length, start <= t <= end with t = float32(i) x float32 dt), in
    oracle.fit_decay_slope's formulas; None below two points."""
    n = curve.shape[-1]
    t = np.arange(n, dtype=np.float32) * np.float32(dt)
    mask = (np.arange(n) < length) & (t >= np.float32(start)) & (t <= np.float32(end))
    assert int(mask.sum()) == num
    if num < 2:
        return None
    ts, ys = t[mask].astype(np.float64), curve[mask].astype(np.float64)
    tm, ym = ts.mean(), ys.mean()
    slope = float(np.sum((ts - tm) * (ys - ym)) / np.sum((ts - tm) ** 2))
    intercept = float(ym - slope * tm)
    ss_res = float(np.sum((ys - (slope * ts + intercept)) ** 2))
    ss_tot = float(np.sum((ys - ym) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0.0 else 0.0
    return slope, intercept, r2, -60.0 / slope if slope < 0.0 else 60.0


def assert_fits_agree(got, ref, curve, lengths, dt: float) -> dict:
    """Every range's kernel fits `got` against the plain fits `ref` of the
    (rows, N) float32 `curve` with int32 `lengths` (numpy); returns the
    largest kernel-plain gap of each summed field and each side's largest
    gap to the float64 fit, for the record."""
    gaps = {name: 0.0 for name in SUMS}
    to_f64 = {"kernel": 0.0, "plain": 0.0}
    for k, (g, r) in enumerate(zip(got, ref)):
        g = {name: getattr(g, name).detach().cpu().numpy().reshape(-1) for name in g._fields}
        r = {name: getattr(r, name).detach().cpu().numpy().reshape(-1) for name in r._fields}
        for name in EXACT:
            np.testing.assert_array_equal(g[name], r[name], err_msg=f"range {k}: {name}")
        scale = {
            "slope_db_per_second": np.maximum(np.abs(r["slope_db_per_second"]), 1e-30),
            "rt60_seconds": np.maximum(np.abs(r["rt60_seconds"]), 1e-30),
            "r_squared": np.ones_like(r["r_squared"]),
            "intercept_db": np.abs(r["slope_db_per_second"]) * r["end_time_seconds"] + 0.1,
        }
        for name in SUMS:
            gap = np.abs(g[name].astype(np.float64) - r[name]) / scale[name]
            gaps[name] = max(gaps[name], float(gap.max(initial=0.0)))
            bad = np.nonzero(~(gap <= TOLERANCE[name]))[0]
            assert bad.size == 0, f"range {k}: {name} rows {bad[:8]}: kernel {g[name][bad[:8]]}, plain {r[name][bad[:8]]}"
        for row in range(curve.shape[0]):
            f64 = window_fit_f64(curve[row], int(r["num_points"][row]), float(r["start_time_seconds"][row]),
                                 float(r["end_time_seconds"][row]), int(lengths[row]), dt)
            if f64 is None:
                continue
            for name, want in zip(("slope_db_per_second", "intercept_db", "r_squared", "rt60_seconds"), f64):
                # RT60 is -60 / the float32 slope: two roundings; an
                # intercept near 0 dB is y_mean - slope x t_mean, a
                # cancellation that leaves float64 about 1e-14 dB
                ulp = float(np.spacing(np.float32(abs(want)))) * (2.0 if name == "rt60_seconds" else 1.0)
                ulp = max(ulp, 1e-12) if name == "intercept_db" else ulp
                k_err, p_err = abs(float(g[name][row]) - want), abs(float(r[name][row]) - want)
                rel = max(abs(want), 1e-30)
                to_f64["kernel"] = max(to_f64["kernel"], k_err / rel)
                to_f64["plain"] = max(to_f64["plain"], p_err / rel)
                assert k_err <= ulp, f"range {k} row {row} {name}: kernel {g[name][row]} vs float64 {want}"
                assert k_err <= max(p_err, ulp), f"range {k} row {row} {name}"
    return {"kernel_vs_plain": gaps, "relative_to_float64": to_f64}


def edge_curves(n: int):
    """(curve, lengths) of rows that corner the fits, n >= 2200: 0 length
    0; 1 a window of fewer than 8 points; 2 a curve that never reaches
    -35 dB; 3 a flat curve (every crossing at index 0, one point in each
    window, s_tt = 0); 4 a curve that starts below -5 dB (crossings at
    index 0); 5 a curve that sits on -5, -10, -25 and -35 dB to the last
    bit; 6 noise that is no decay at all, cut 5 samples short."""
    rows = np.stack([
        np.linspace(0.0, -60.0, n, dtype=np.float32),
        np.maximum(np.linspace(0.0, -24000.0, n, dtype=np.float32), -120.0),
        np.linspace(0.0, -30.0, n, dtype=np.float32),
        np.full(n, -120.0, np.float32),
        np.linspace(-6.0, -80.0, n, dtype=np.float32),
        np.linspace(0.0, -60.0, n, dtype=np.float32),
        np.random.default_rng(3).uniform(-60.0, 0.0, n).astype(np.float32),
    ])
    rows[5, [300, 600, 1500, 2100]] = [-5.0, -10.0, -25.0, -35.0]
    return torch.from_numpy(rows), torch.tensor([0, n, n, n, n, n, n - 5], dtype=torch.int32)


def assert_edge_rows_cornered(ref) -> None:
    """Each row of edge_curves does what it is there for, in the T30 fit
    (and the EDT fit for row 2) of the plain version's engine ranges."""
    t30, edt = ref[0], ref[2]
    assert int(t30.num_points[0]) == 0 and not bool(t30.ok[0])
    assert 0 < int(t30.num_points[1]) < 8 and not bool(t30.ok[1])
    assert not bool(t30.ok[2]) and bool(edt.ok[2])
    assert int(t30.num_points[3]) == 1 and float(t30.slope_db_per_second[3]) == 0.0
    assert float(t30.start_time_seconds[4]) == 0.0 and bool(t30.ok[4])
    assert bool(t30.ok[5])
