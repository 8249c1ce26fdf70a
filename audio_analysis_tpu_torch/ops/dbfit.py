"""
Decay-curve metrology (audio_analysis_tpu/ops/dbfit.py): interpolated dB
crossings and masked least-squares line fits over dB ranges (slope, r^2,
RT60 = -60/slope), batched over any leading dims.

The time axis is index x (1/sr), the reciprocal rounded to float32, not
index / sr: XLA rewrites the JAX package's division by the static rate as
that product, and the quotients differ by one ulp at about an eighth of
the indices. A fit over a few samples far into a curve (t - mean(t) a few
ulps of t) moves by 1e-4 relative with it.

`fit_decay_ranges` fits several dB ranges of one curve plane at once, as
the engine's decay and band blocks do. It is the wrapper of kernel K5
(csrc/dbfit.cu, which replaces no TPU kernel): on a CUDA tensor it launches
the kernel, on a CPU tensor it runs `fit_decay_ranges_plain`, one
`fit_decay_slope_over_db_range` a range. The kernel's crossing times and
point counts are the plain version's to the bit; its sums run in float64
over the same windows, so slope, intercept, r^2 and RT60 are the float64
fit's rounded once to float32, where the plain version sums in float32.
The `ok` flags are the plain version's to the bit wherever the slope's
sign is clear of the float32 sums' rounding: on every curve that does not
increase, which is what the engine fits (its EDCs); on a window where the
curve is all but flat the two may disagree. tests/test_torch_dbfit_host.py
here, and tests/test_torch_cuda.py on the card, hold the two together and
to a float64 fit over the same window.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from audio_analysis_tpu_torch import _build
from audio_analysis_tpu_torch.ops.common import bool_valid_mask

DBFIT_KERNEL = _build.LaunchCounter("dbfit")
# ranges one fit_decay_ranges call takes, on either device: the size of
# K5's per-range arrays (csrc/dbfit.cu kMaxRanges, whose C entry refuses
# more; tests/test_torch_dbfit_host.py holds the two equal)
MAX_RANGES = 4


class Crossing(NamedTuple):
    time_seconds: torch.Tensor  # (...,) f32 (garbage where not found)
    found: torch.Tensor  # (...,) bool


class DecayFit(NamedTuple):
    slope_db_per_second: torch.Tensor
    intercept_db: torch.Tensor
    r_squared: torch.Tensor
    rt60_seconds: torch.Tensor
    start_time_seconds: torch.Tensor
    end_time_seconds: torch.Tensor
    num_points: torch.Tensor  # int32
    ok: torch.Tensor  # bool: valid fit (range found, >= min points, slope < 0)


def _seconds_per_sample(sample_rate_hz: float) -> float:
    """1/sample_rate_hz rounded to float32 (exact as a Python float)."""
    return float(np.float32(1.0) / np.float32(sample_rate_hz))


def crossing_time(
    curve_db: torch.Tensor,
    length: torch.Tensor,
    target_db: float,
    sample_rate_hz: float,
) -> Crossing:
    """
    First time the curve reaches <= target_db, linearly interpolated between
    the bracketing samples (decay.py:173-199). Time axis is index/sr (as
    index x _seconds_per_sample).
    """
    n = curve_db.shape[-1]
    valid = bool_valid_mask(n, length)
    below = (curve_db <= float(target_db)) & valid
    found = torch.any(below, dim=-1)
    # torch.argmax takes no bool; on 0/1 it returns the first True
    idx = torch.argmax(below.to(torch.uint8), dim=-1)

    prev = torch.clamp(idx - 1, min=0)
    y0 = torch.gather(curve_db, -1, prev[..., None])[..., 0]
    y1 = torch.gather(curve_db, -1, idx[..., None])[..., 0]

    dt = _seconds_per_sample(sample_rate_hz)
    t0 = prev.to(torch.float32) * dt
    t1 = idx.to(torch.float32) * dt
    same = y1 == y0
    frac = torch.clamp((float(target_db) - y0) / torch.where(same, 1.0, y1 - y0), 0.0, 1.0)
    t_interp = torch.where(same, t1, t0 + frac * (t1 - t0))
    t = torch.where(idx == 0, 0.0, t_interp)
    return Crossing(t.to(torch.float32), found)


def fit_decay_slope_over_db_range(
    curve_db: torch.Tensor,
    length: torch.Tensor,
    range_db: Tuple[float, float],
    fit_lower_limit_db: float,
    sample_rate_hz: float,
    min_points: int = 8,
) -> DecayFit:
    """
    Fit y = m t + b over the curve section between the interpolated crossings
    of range_db[0] (higher) and max(range_db[1], fit_lower_limit_db), reject
    non-decaying fits, derive RT60 = -60/m (decay.py:202-260).
    """
    high_db, low_db = float(range_db[0]), float(range_db[1])
    effective_low_db = max(low_db, float(fit_lower_limit_db))

    start = crossing_time(curve_db, length, high_db, sample_rate_hz)
    end = crossing_time(curve_db, length, effective_low_db, sample_rate_hz)

    n = curve_db.shape[-1]
    t = torch.arange(n, dtype=torch.float32, device=curve_db.device) * _seconds_per_sample(sample_rate_hz)
    valid = bool_valid_mask(n, length)
    window = (
        valid
        & (t >= start.time_seconds[..., None])
        & (t <= end.time_seconds[..., None])
    )
    num = window.sum(dim=-1, dtype=torch.int32)
    num_safe = torch.clamp(num, min=1).to(torch.float32)

    # centred weighted least squares (identical to lstsq on [t, 1])
    y = torch.where(window, curve_db, 0.0)
    tw = torch.where(window, t, 0.0)
    t_mean = tw.sum(dim=-1) / num_safe
    y_mean = y.sum(dim=-1) / num_safe
    dt = torch.where(window, t - t_mean[..., None], 0.0)
    dy = torch.where(window, curve_db - y_mean[..., None], 0.0)

    s_tt = (dt * dt).sum(dim=-1)
    s_ty = (dt * dy).sum(dim=-1)
    slope = s_ty / torch.where(s_tt > 0.0, s_tt, 1.0)
    intercept = y_mean - slope * t_mean

    resid = torch.where(window, dy - slope[..., None] * dt, 0.0)
    ss_res = (resid * resid).sum(dim=-1)
    ss_tot = (dy * dy).sum(dim=-1)
    tot_ok = ss_tot > 0.0
    r2 = torch.where(tot_ok, 1.0 - ss_res / torch.where(tot_ok, ss_tot, 1.0), 0.0)

    ok = (
        start.found
        & end.found
        & (end.time_seconds > start.time_seconds)
        & (num >= min_points)
        & (slope < 0.0)
        & (s_tt > 0.0)
    )
    rt60 = -60.0 / torch.where(slope < 0.0, slope, -1.0)

    return DecayFit(
        slope_db_per_second=slope,
        intercept_db=intercept,
        r_squared=r2,
        rt60_seconds=rt60,
        start_time_seconds=start.time_seconds,
        end_time_seconds=end.time_seconds,
        num_points=num,
        ok=ok,
    )


def fit_decay_ranges_plain(
    curve_db: torch.Tensor,
    length: torch.Tensor,
    ranges: Sequence[Tuple[float, float]],
    fit_lower_limit_db: float,
    sample_rate_hz: float,
    min_points: int = 8,
) -> Tuple[DecayFit, ...]:
    """The plain version of `fit_decay_ranges`: one
    `fit_decay_slope_over_db_range` a range."""
    return tuple(
        fit_decay_slope_over_db_range(curve_db, length, r, fit_lower_limit_db, sample_rate_hz, min_points)
        for r in ranges
    )


def run_kernel(
    lib,
    curve_db: torch.Tensor,
    length: torch.Tensor,
    ranges: Sequence[Tuple[float, float]],
    fit_lower_limit_db: float,
    sample_rate_hz: float,
    min_points: int,
    stream,
) -> Tuple[int, Tuple[DecayFit, ...]]:
    """(error code, fits): K5's C entry `aa_dbfit` of `lib` on a contiguous
    float32 (..., N) curve, every buffer on the curve's device (the card's,
    or the host's where the tests build the kernel source for the CPU)."""
    n = curve_db.shape[-1]
    if n == 0:
        raise ValueError("decay fits need a curve of at least one sample")
    batch_shape = curve_db.shape[:-1]
    rows = curve_db.numel() // n
    lengths = (
        torch.broadcast_to(length.to(device=curve_db.device, dtype=torch.int32), batch_shape)
        .contiguous()
        .reshape(-1)
    )
    k = len(ranges)
    out_f = torch.empty((k, 6, rows), dtype=torch.float32, device=curve_db.device)
    out_num = torch.empty((k, rows), dtype=torch.int32, device=curve_db.device)
    out_ok = torch.empty((k, rows), dtype=torch.bool, device=curve_db.device)
    code = 0
    if rows:
        scratch_bytes = lib.aa_dbfit_scratch_bytes(rows, n)
        if scratch_bytes < 0:
            raise ValueError(f"decay-fit kernel does not take {rows} rows of {n} samples")
        scratch = torch.empty(scratch_bytes // 8, dtype=torch.float64, device=curve_db.device)
        # each range's upper level and effective lower level, as the plain
        # version forms them
        levels = [v for high, low in ranges for v in (float(high), max(float(low), float(fit_lower_limit_db)))]
        range_db = (ctypes.c_float * len(levels))(*levels)
        code = lib.aa_dbfit(
            curve_db.data_ptr(), lengths.data_ptr(), scratch.data_ptr(), out_f.data_ptr(), out_num.data_ptr(),
            out_ok.data_ptr(), rows, n, _seconds_per_sample(sample_rate_hz), ctypes.addressof(range_db), k,
            int(min_points), stream,
        )
    fits = []
    for r in range(k):
        f = out_f[r].reshape(6, *batch_shape)
        fits.append(DecayFit(f[0], f[1], f[2], f[3], f[4], f[5],
                             out_num[r].reshape(batch_shape), out_ok[r].reshape(batch_shape)))
    return code, tuple(fits)


def fit_decay_ranges_cuda(
    curve_db: torch.Tensor,
    length: torch.Tensor,
    ranges: Sequence[Tuple[float, float]],
    fit_lower_limit_db: float,
    sample_rate_hz: float,
    min_points: int = 8,
) -> Tuple[DecayFit, ...]:
    """Kernel K5 on a contiguous CUDA float32 curve (..., N)."""
    if curve_db.device.type != "cuda" or curve_db.dtype != torch.float32 or not curve_db.is_contiguous():
        raise TypeError(
            f"decay-fit kernel takes a contiguous CUDA float32 tensor, got {curve_db.dtype} on "
            f"{curve_db.device} (contiguous: {curve_db.is_contiguous()})"
        )
    with torch.cuda.device(curve_db.device):
        stream = torch.cuda.current_stream(curve_db.device).cuda_stream
        code, fits = run_kernel(_build.library(), curve_db, length, ranges, fit_lower_limit_db, sample_rate_hz,
                                min_points, stream)
    _build.check(code, "decay-fit kernel")
    if curve_db.numel():
        DBFIT_KERNEL.launches += 1
    return fits


def fit_decay_ranges(
    curve_db: torch.Tensor,
    length: torch.Tensor,
    ranges: Sequence[Tuple[float, float]],
    fit_lower_limit_db: float,
    sample_rate_hz: float,
    min_points: int = 8,
) -> Tuple[DecayFit, ...]:
    """
    `fit_decay_slope_over_db_range` for each of up to MAX_RANGES ranges of
    one (..., N) dB curve, in the order given: on a CUDA tensor one launch
    of K5 (a contiguous float32 curve, or it raises), on a CPU tensor the
    plain version.
    """
    if not 1 <= len(ranges) <= MAX_RANGES:
        raise ValueError(f"fit_decay_ranges takes 1 to {MAX_RANGES} ranges, got {len(ranges)}")
    if curve_db.device.type == "cuda":
        return fit_decay_ranges_cuda(curve_db, length, ranges, fit_lower_limit_db, sample_rate_hz, min_points)
    if curve_db.device.type == "cpu":
        return fit_decay_ranges_plain(curve_db, length, ranges, fit_lower_limit_db, sample_rate_hz, min_points)
    raise ValueError(f"unsupported device {curve_db.device}")
