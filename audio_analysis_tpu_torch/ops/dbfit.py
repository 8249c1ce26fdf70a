"""
Decay-curve metrology (audio_analysis_tpu/ops/dbfit.py): interpolated dB
crossings and masked least-squares line fits over dB ranges (slope, r^2,
RT60 = -60/slope), batched over any leading dims.

The time axis is index x (1/sr), the reciprocal rounded to float32, not
index / sr: XLA rewrites the JAX package's division by the static rate as
that product, and the quotients differ by one ulp at about an eighth of
the indices. A fit over a few samples far into a curve (t - mean(t) a few
ulps of t) moves by 1e-4 relative with it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from audio_analysis_tpu_torch.ops.common import bool_valid_mask


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
