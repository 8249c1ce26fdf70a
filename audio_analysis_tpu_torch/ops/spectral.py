"""
Single-segment spectra and the AR fit (audio_analysis_tpu/ops/spectral.py):
magnitude spectrum with its peak and centroid, phase, group delay and
regularised sweep deconvolution on torch.fft; the covariance-method AR
normal equations as batched float32 matrix products on the device, and
their float64 solve, poles and FIR zeros on the host (numpy).

Segments arrive aligned at index 0 of a padded buffer with a valid length
alongside (see ops.trim); windows are built at the valid length and the
FFT runs at the buffer length (zero-padded: a denser sampling of the same
windowed DTFT, as the JAX package does).
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


class ArFitResult(NamedTuple):
    gram: torch.Tensor  # (..., p, p) A^T A
    moment: torch.Tensor  # (..., p)   A^T y


# rows per float32 product: cuBLAS sums each product's rows one after
# another in float32, and over 65,536 rows of a decaying IR the small late
# products fall below half an ulp of the running sum (a 9e-5 relative
# Gram error measured on an H100); 1,024-row blocks keep each sum short,
# and their many products fill the card where 65,536-row ones did not
_BLOCK_ROWS = 1024


def ar_normal_equations(
    x: torch.Tensor,
    length: torch.Tensor,
    order: int,
    chunk: int = 65536,
) -> ArFitResult:
    """
    The exact least-squares normal equations of the AR(p) model
    x[n] + sum_k a[k] x[n-k] = e[n]: rows n = p..L-1, A[r, k-1] = x[n-k],
    y = -x[n], rows at or past min(length, N) zero. Gram and moment are
    accumulated in float32 over row chunks; each chunk is one batched
    product over every channel and every block of _BLOCK_ROWS rows,
    (C * blocks, p, rows) @ (C * blocks, rows, p), whose block sums are
    then added. The lag window is an unfold view of the signal (columns in
    reverse lag order, so the sums are flipped back at the end).
    """
    n = x.shape[-1]
    p = int(order)
    num_chunks = max(1, -(-max(0, n - p) // chunk))
    blocks = chunk // _BLOCK_ROWS if chunk % _BLOCK_ROWS == 0 else 1
    batch_shape = x.shape[:-1]
    xf = x.reshape(-1, n).to(torch.float32)
    c = xf.shape[0]
    limit = torch.clamp(torch.broadcast_to(length.to(torch.int32), batch_shape).reshape(-1), max=n)
    # zeros past the end: the last chunk's windows read them, masked
    xp = torch.nn.functional.pad(xf, (0, max(0, p + num_chunks * chunk - n)))
    gram = torch.zeros((c, p, p), dtype=torch.float32, device=x.device)
    moment = torch.zeros((c, p, 1), dtype=torch.float32, device=x.device)
    for k in range(num_chunks):
        row0 = p + k * chunk
        rows = row0 + torch.arange(chunk, device=x.device)
        ok = (rows[None, :] < limit[:, None]).to(torch.float32)  # (C, chunk)
        # window r holds x[row0 + r - p .. row0 + r - 1]: lags p..1
        a = (xp[:, row0 - p : row0 + chunk - 1].unfold(-1, p, 1) * ok[:, :, None]).reshape(c * blocks, -1, p)
        y = (-xp[:, row0 : row0 + chunk] * ok).reshape(c * blocks, -1, 1)
        gram += torch.bmm(a.transpose(1, 2), a).view(c, blocks, p, p).sum(dim=1)
        moment += torch.bmm(a.transpose(1, 2), y).view(c, blocks, p, 1).sum(dim=1)
    gram = torch.flip(gram, dims=(1, 2))
    moment = torch.flip(moment[..., 0], dims=(1,))
    return ArFitResult(gram.reshape(batch_shape + (p, p)), moment.reshape(batch_shape + (p,)))


def solve_ar_coefficients(
    gram: np.ndarray,
    moment: np.ndarray,
    ridge_lambda: float = 0.0,
    rcond: float = 1e-6,
) -> np.ndarray:
    """
    Host float64 solve of the normal equations -> AR coefficients with
    a[0] = 1. The Gram was accumulated in float32, so its entries carry
    about 1e-7 relative noise: singular directions below `rcond` of the
    largest are accumulation noise, and truncating them (lstsq with
    rcond=1e-6, ridge on the diagonal first) keeps ill-conditioned fits
    (order well above the true mode count) from turning that noise into
    wild poles. Well-conditioned fits get the exact solve.
    """
    g = np.asarray(gram, dtype=np.float64)
    m = np.asarray(moment, dtype=np.float64)
    p = g.shape[-1]
    if ridge_lambda and ridge_lambda > 0.0:
        g = g + ridge_lambda * np.eye(p)
    rest, *_ = np.linalg.lstsq(g, m, rcond=rcond)
    return np.concatenate(([1.0], rest))


def ar_poles(a: np.ndarray) -> np.ndarray:
    """
    Poles of A(z) = 1 + a1 z^-1 + ... + ap z^-p: the roots of
    z^p + a1 z^(p-1) + ... + ap after stripping trailing near-zero
    coefficients (host numpy, a complex nonsymmetric eigensolve).
    """
    poly = np.asarray(a, dtype=np.float64)
    while poly.size > 1 and abs(poly[-1]) < 1e-14:
        poly = poly[:-1]
    if poly.size <= 1:
        return np.array([], dtype=np.complex128)
    return np.roots(poly)


def derive_fir_numerator_from_ar(a: np.ndarray, h: np.ndarray, zero_order: int) -> np.ndarray:
    """b[n] = sum_k a[k] h[n-k] for n = 0..Q: one host convolution."""
    a = np.asarray(a, dtype=np.float64)
    h = np.asarray(h, dtype=np.float64)
    q = int(max(0, zero_order))
    full = np.convolve(a, h)
    b = np.zeros(q + 1)
    take = min(q + 1, full.size)
    b[:take] = full[:take]
    return b
