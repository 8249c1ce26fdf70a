"""
Sliding-window diffusion / decorrelation metrics
(audio_analysis_tpu/ops/diffusion.py), per window:
- max |normalised autocorrelation| over lags 1..L,
- echo density (fraction of |x| above k*rms, optionally normalised by the
  Gaussian expectation 2(1-Phi(k))),
- zero-lag Pearson correlation corr0 and IACC-like max |cross-correlation|
  over lags -L..L for stereo pairs.

Every window is a row of a framed view, and all lags of a window come from
one zero-padded rfft/irfft pair (Wiener-Khinchin), with
n_fft = next_pow2(win + max_lag + 1).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from audio_analysis_tpu_torch.ops.common import next_pow2
from audio_analysis_tpu_torch.ops.stft import frame_signal, num_frames_static


class DiffusionSeries(NamedTuple):
    time_seconds: torch.Tensor  # (T,) frame centres
    max_abs_autocorr: torch.Tensor  # (..., T), NaN where invalid
    echo_density: torch.Tensor  # (..., T), NaN where invalid
    num_frames: torch.Tensor  # (...,) int32 valid frame count


class StereoDiffusionSeries(NamedTuple):
    corr0: torch.Tensor  # (..., T)
    iacc_max: torch.Tensor  # (..., T)


def _frames_and_validity(x: torch.Tensor, length: torch.Tensor, win: int, hop: int):
    frames = frame_signal(x, win, hop)  # (..., T, win)
    t = frames.shape[-2]
    starts = torch.arange(t, dtype=torch.int32, device=x.device) * hop
    return frames, starts + win <= length[..., None]


def _centered(frames: torch.Tensor) -> torch.Tensor:
    return frames - frames.mean(dim=-1, keepdim=True)


def diffusion_metrics(
    x: torch.Tensor,
    length: torch.Tensor,
    win: int,
    hop: int,
    max_lag: int,
    sample_rate_hz: int,
    threshold_rms: float = 1.0,
    normalise_to_gaussian: bool = True,
) -> DiffusionSeries:
    """Windowed max|autocorr| and echo density for (..., N) aligned signals."""
    frames, frame_valid = _frames_and_validity(x, length, win, hop)
    x0 = _centered(frames)

    n_fft = next_pow2(win + max_lag + 1)
    spec = torch.fft.rfft(x0, n=n_fft, dim=-1)
    acorr = torch.fft.irfft(spec * torch.conj(spec), n=n_fft, dim=-1)
    denom = acorr[..., 0]  # = sum x0^2
    lag_slice = torch.abs(acorr[..., 1 : max_lag + 1])
    # the reference caps the lag range at window-2 (diffusion.py:147)
    usable = min(max_lag, win - 2)
    lag_mask = torch.arange(1, max_lag + 1, device=x.device) <= usable
    best = torch.where(lag_mask, lag_slice, 0.0).amax(dim=-1)
    denom_ok = denom > 1e-20
    max_abs_ac = torch.where(denom_ok, best / torch.where(denom_ok, denom, 1.0), math.nan)

    rms = torch.sqrt((x0 * x0).mean(dim=-1))
    thr = threshold_rms * rms
    frac = (torch.abs(x0) > thr[..., None]).to(torch.float32).mean(dim=-1)
    if normalise_to_gaussian:
        phi = 0.5 * (1.0 + math.erf(threshold_rms / math.sqrt(2.0)))
        expected = 2.0 * (1.0 - phi)
        frac = frac / expected if expected > 1e-12 else frac * math.nan
    echo = torch.where(rms > 1e-20, frac, math.nan)

    invalid = ~frame_valid
    t = frames.shape[-2]
    times = (torch.arange(t, dtype=torch.float32, device=x.device) * hop + 0.5 * win) / float(
        sample_rate_hz
    )
    return DiffusionSeries(
        time_seconds=times,
        max_abs_autocorr=torch.where(invalid, math.nan, max_abs_ac),
        echo_density=torch.where(invalid, math.nan, echo),
        num_frames=frame_valid.sum(dim=-1, dtype=torch.int32),
    )


def stereo_diffusion_metrics(
    left: torch.Tensor,
    right: torch.Tensor,
    length: torch.Tensor,
    win: int,
    hop: int,
    max_lag: int,
) -> StereoDiffusionSeries:
    """corr0 + IACC max over +-lags for aligned stereo pairs (..., N)."""
    lf, frame_valid = _frames_and_validity(left, length, win, hop)
    rf, _ = _frames_and_validity(right, length, win, hop)
    x0, y0 = _centered(lf), _centered(rf)

    ex = (x0 * x0).sum(dim=-1)
    ey = (y0 * y0).sum(dim=-1)
    denom = torch.sqrt(ex * ey)
    denom_ok = denom > 1e-20
    safe = torch.where(denom_ok, denom, 1.0)

    corr0 = torch.where(denom_ok, (x0 * y0).sum(dim=-1) / safe, math.nan)

    # cross-correlation for all lags at once: c[l] = sum x0[n] y0[n+l]
    n_fft = next_pow2(win + max_lag + 1)
    fx = torch.fft.rfft(x0, n=n_fft, dim=-1)
    fy = torch.fft.rfft(y0, n=n_fft, dim=-1)
    xc = torch.fft.irfft(torch.conj(fx) * fy, n=n_fft, dim=-1)
    xc_pos = xc[..., : max_lag + 1]
    xc_neg = torch.flip(xc[..., n_fft - max_lag :], (-1,))
    usable = min(max_lag, win - 2)
    lag_ok_pos = torch.arange(0, max_lag + 1, device=left.device) <= usable
    lag_ok_neg = torch.arange(1, max_lag + 1, device=left.device) <= usable
    pos = torch.where(lag_ok_pos, torch.abs(xc_pos), 0.0).amax(dim=-1)
    neg = torch.where(lag_ok_neg, torch.abs(xc_neg), 0.0).amax(dim=-1)
    iacc = torch.where(denom_ok, torch.maximum(pos, neg) / safe, math.nan)

    invalid = ~frame_valid
    return StereoDiffusionSeries(
        corr0=torch.where(invalid, math.nan, corr0),
        iacc_max=torch.where(invalid, math.nan, iacc),
    )


def stereo_diffusion_metrics_rows(
    samples: torch.Tensor,
    length: torch.Tensor,
    win: int,
    hop: int,
    max_lag: int,
) -> StereoDiffusionSeries:
    """`stereo_diffusion_metrics` on the (..., 2, N) aligned L/R row layout
    (the left row's length governs both)."""
    return stereo_diffusion_metrics(
        samples[..., 0:1, :], samples[..., 1:2, :], length[..., 0:1], win, hop, max_lag
    )


def diffusion_frame_times(n: int, win: int, hop: int, sample_rate_hz: int) -> np.ndarray:
    """Host-side window-centre times of the `n`-sample framing."""
    t = num_frames_static(n, win, hop)
    return ((np.arange(t) * hop + 0.5 * win) / float(sample_rate_hz)).astype(np.float32)
