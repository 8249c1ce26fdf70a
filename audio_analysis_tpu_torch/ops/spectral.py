"""
Single-segment spectra (audio_analysis_tpu/ops/spectral.py:54-180):
magnitude spectrum with its peak and centroid, phase, group delay, and
regularised sweep deconvolution, on torch.fft.

Segments arrive aligned at index 0 of a padded buffer with a valid length
alongside (see ops.trim); windows are built at the valid length and the
FFT runs at the buffer length (zero-padded: a denser sampling of the same
windowed DTFT, as the JAX package does). The AR half of that module (the
z-plane) is not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from audio_analysis_tpu_torch.ops import common, selectq
from audio_analysis_tpu_torch.ops.common import (
    bool_valid_mask,
    box_smooth_same,
    db_from_magnitude,
    hann_window_dynamic,
)


class SpectrumResult(NamedTuple):
    mag_db: torch.Tensor  # (..., F)
    phase: torch.Tensor  # (..., F) radians (unwrapped if requested)
    peak_frequency_hz: torch.Tensor  # (...,) within [f_min, f_max]
    spectral_centroid_hz: torch.Tensor  # (...,) amplitude-weighted
    magnitude_at_1khz_db: torch.Tensor  # (...,)


def _windowed(x: torch.Tensor, length: torch.Tensor, use_hann_window: bool) -> torch.Tensor:
    n = x.shape[-1]
    if use_hann_window:
        return x * hann_window_dynamic(n, length)
    return torch.where(bool_valid_mask(n, length), x, 0.0)


def segment_spectrum(
    x: torch.Tensor,
    length: torch.Tensor,
    sample_rate_hz: int,
    use_hann_window: bool = True,
    magnitude_floor_db: float = -120.0,
    f_min_hz: float = 20.0,
    f_max_hz: float = 20000.0,
    unwrap_phase: bool = True,
) -> SpectrumResult:
    """x: (..., N) aligned segment. One rfft feeds the magnitude, the phase
    and the peak / centroid / 1 kHz diagnostics over [f_min, f_max]."""
    n = x.shape[-1]
    spectrum = torch.fft.rfft(_windowed(x, length, use_hann_window), dim=-1)
    mag_db = db_from_magnitude(torch.abs(spectrum), magnitude_floor_db)
    phase = torch.angle(spectrum)
    if unwrap_phase:
        phase = common.unwrap(phase)

    freqs_np = np.fft.rfftfreq(n, d=1.0 / float(sample_rate_hz)).astype(np.float32)
    nyquist = 0.5 * float(sample_rate_hz)
    f_lo = float(np.clip(f_min_hz, 0.0, nyquist))
    f_hi = float(np.clip(f_max_hz, f_lo, nyquist))
    sel_np = (freqs_np >= f_lo) & (freqs_np <= f_hi)
    first_sel_freq = float(freqs_np[np.argmax(sel_np)]) if np.any(sel_np) else 0.0
    freqs = torch.from_numpy(freqs_np).to(x.device)
    sel = torch.from_numpy(sel_np).to(x.device)

    peak_freq = freqs[torch.argmax(torch.where(sel, mag_db, -math.inf), dim=-1)]
    mag_sel_lin = torch.where(sel, 10.0 ** (mag_db / 20.0), 0.0)
    weight_sum = mag_sel_lin.sum(dim=-1)
    centroid = (mag_sel_lin * freqs).sum(dim=-1) / torch.where(weight_sum > 0.0, weight_sum, 1.0)
    centroid = torch.where(weight_sum > 0.0, centroid, first_sel_freq)

    idx_1k = int(np.argmin(np.abs(np.fft.rfftfreq(n, 1.0 / sample_rate_hz) - 1000.0)))
    return SpectrumResult(mag_db, phase, peak_freq, centroid, mag_db[..., idx_1k])


class GroupDelayResult(NamedTuple):
    group_delay_samples: torch.Tensor  # (..., F)
    median: torch.Tensor  # (...,) over [f_min, f_max]
    p10: torch.Tensor
    p90: torch.Tensor


def group_delay(
    x: torch.Tensor,
    length: torch.Tensor,
    sample_rate_hz: int,
    use_hann_window: bool = True,
    unwrap: bool = True,
    smoothing_bins: int = 0,
    f_min_hz: float = 20.0,
    f_max_hz: float = 20000.0,
) -> GroupDelayResult:
    """
    gd(w) = -dphi/dw in samples, w in rad/sample, phi the (optionally
    unwrapped) rfft phase, central differences with one-sided ends as
    np.gradient; optional box smoothing over bins. The FFT length is the
    buffer length. Percentiles are exact over the bins in [f_min, f_max].
    """
    n = x.shape[-1]
    spectrum = torch.fft.rfft(_windowed(x, length, use_hann_window), dim=-1)
    phase = torch.angle(spectrum)
    if unwrap:
        phase = common.unwrap(phase)
    dw = 2.0 * math.pi / n
    gd = -(torch.gradient(phase, dim=-1)[0] / dw)
    if smoothing_bins and smoothing_bins > 1:
        gd = box_smooth_same(gd, int(smoothing_bins))

    freqs = np.fft.rfftfreq(n, d=1.0 / float(sample_rate_hz))
    sel = torch.from_numpy((freqs >= f_min_hz) & (freqs <= f_max_hz)).to(x.device)
    q = selectq.masked_percentiles(gd, torch.broadcast_to(sel, gd.shape), (10.0, 50.0, 90.0))
    return GroupDelayResult(gd, q[..., 1], q[..., 0], q[..., 2])


def deconvolve_spectral(
    recorded: torch.Tensor,  # (..., C, Ny), zero-padded
    sweep: torch.Tensor,  # (Nx,) mono excitation
    n_fft: int,
    regularization_relative: float = 1e-10,
) -> torch.Tensor:
    """
    H = Y conj(X) / (|X|^2 + eps), eps = rel * max|X|^2 (deconvolve.py:150-171).
    Returns the time-domain IR (..., C, n_fft) in float32; the caller trims
    it, removes DC and normalises the peak.
    """
    spec_x = torch.fft.rfft(sweep, n=n_fft)
    power = torch.abs(spec_x) ** 2
    eps = regularization_relative * torch.clamp(power.max(), min=1e-30)
    spec_y = torch.fft.rfft(recorded, n=n_fft, dim=-1)
    h = spec_y * torch.conj(spec_x) / (power + eps)
    return torch.fft.irfft(h, n=n_fft, dim=-1).to(torch.float32)
