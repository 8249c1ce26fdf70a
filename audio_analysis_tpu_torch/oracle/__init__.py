"""
Float64 NumPy oracle of the port: a copy of audio_analysis_tpu/oracle, the
straight re-implementations of the reference's formulas, kept in the port
so that its tests and chip_smoke.py have the independent ground truth
without loading the JAX package. Deliberately simple and slow (slice-based,
loop-based): this is the algorithmic contract the CUDA kernels and their
plain torch versions must match within tolerance. It imports numpy only.

Formula sources (file:line in the reference NumPy tool, kianmcevoy/audio_analysis):
- Schroeder EDC: decay.py:115-170
- interpolated dB crossing: decay.py:173-199
- dB-range line fit + RT60: decay.py:202-260
- STFT magnitude dB, valid framing: spectrogram.py:107-160
- raised-cosine FFT masks: rt60bands.py:116-175
- Tikhonov deconvolution: deconvolve.py:124-193
- windowed autocorr / echo density / corr0 / IACC: diffusion.py:132-226
- AR least squares: zplane.py:83-120
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np


# ----------------------------------------------------------------------------
# decay / EDC
# ----------------------------------------------------------------------------


def schroeder_edc_db(
    samples: np.ndarray,
    sample_rate_hz: int,
    trim_to_peak: bool = True,
    ignore_leading_seconds: float = 0.0,
    edc_epsilon: float = 1e-20,
    edc_floor_db: float = -120.0,
    smoothing_window_samples: int = 0,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """time_seconds, edc_db (0 dB at segment start), analysis_start_index."""
    x = np.asarray(samples, dtype=np.float64)
    start = 0
    if trim_to_peak:
        start = int(np.argmax(np.abs(x)))
        x = x[start:]
    if ignore_leading_seconds > 0.0:
        skip = int(round(ignore_leading_seconds * sample_rate_hz))
        skip = max(0, min(skip, x.size))
        start += skip
        x = x[skip:]
    if x.size < 4:
        raise ValueError("Not enough samples after trimming/ignoring to compute EDC.")

    energy = x * x
    edc = np.cumsum(energy[::-1])[::-1]
    edc = np.maximum(edc, edc_epsilon)
    edc = edc / edc[0]
    edc_db = 10.0 * np.log10(edc)

    if smoothing_window_samples and smoothing_window_samples > 1:
        kernel = np.ones(smoothing_window_samples) / smoothing_window_samples
        edc_db = np.convolve(edc_db, kernel, mode="same")

    edc_db = np.maximum(edc_db, edc_floor_db)
    t = np.arange(edc_db.size, dtype=np.float64) / sample_rate_hz
    return t, edc_db, start


def crossing_time(t: np.ndarray, curve_db: np.ndarray, target_db: float) -> Optional[float]:
    below = curve_db <= target_db
    if not np.any(below):
        return None
    idx = int(np.argmax(below))
    if idx == 0:
        return float(t[0])
    t0, t1 = float(t[idx - 1]), float(t[idx])
    y0, y1 = float(curve_db[idx - 1]), float(curve_db[idx])
    if y1 == y0:
        return t1
    frac = float(np.clip((target_db - y0) / (y1 - y0), 0.0, 1.0))
    return t0 + frac * (t1 - t0)


def fit_decay_slope(
    t: np.ndarray,
    curve_db: np.ndarray,
    range_db: Tuple[float, float],
    fit_lower_limit_db: float = -80.0,
    min_points: int = 8,
) -> Optional[Tuple[float, float, float, float]]:
    """(slope_db_per_s, intercept_db, r_squared, rt60_seconds) or None."""
    high_db, low_db = float(range_db[0]), float(range_db[1])
    effective_low = max(low_db, fit_lower_limit_db)
    t_start = crossing_time(t, curve_db, high_db)
    t_end = crossing_time(t, curve_db, effective_low)
    if t_start is None or t_end is None or t_end <= t_start:
        return None
    mask = (t >= t_start) & (t <= t_end)
    if int(np.sum(mask)) < min_points:
        return None
    ts, ys = t[mask], curve_db[mask]
    tm, ym = ts.mean(), ys.mean()
    denom = np.sum((ts - tm) ** 2)
    if denom <= 0.0:
        return None
    slope = float(np.sum((ts - tm) * (ys - ym)) / denom)
    intercept = float(ym - slope * tm)
    if slope >= 0.0:
        return None
    pred = slope * ts + intercept
    ss_res = float(np.sum((ys - pred) ** 2))
    ss_tot = float(np.sum((ys - ym) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0.0 else 0.0
    return slope, intercept, r2, -60.0 / slope


# ----------------------------------------------------------------------------
# STFT
# ----------------------------------------------------------------------------


def stft_magnitude_db(
    samples: np.ndarray,
    sample_rate_hz: int,
    n_fft: int,
    hop_length: int,
    use_hann_window: bool = True,
    floor_db: float = -120.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(time_s (T,), freq_hz (F,), mag_db (F, T)); valid framing, frame-start times."""
    x = np.asarray(samples, dtype=np.float64)
    if x.size < n_fft:
        raise ValueError("Not enough samples for STFT (need at least n_fft).")
    num_frames = 1 + (x.size - n_fft) // hop_length
    window = np.hanning(n_fft) if use_hann_window else np.ones(n_fft)
    freq = np.fft.rfftfreq(n_fft, d=1.0 / sample_rate_hz)
    floor_lin = 10.0 ** (floor_db / 20.0)

    mag_db = np.empty((freq.size, num_frames), dtype=np.float64)
    for i in range(num_frames):
        frame = x[i * hop_length : i * hop_length + n_fft] * window
        mag = np.maximum(np.abs(np.fft.rfft(frame)), floor_lin)
        mag_db[:, i] = 20.0 * np.log10(mag)
    t = np.arange(num_frames, dtype=np.float64) * hop_length / sample_rate_hz
    return t, freq, mag_db


def waterfall_rel_db_slices(
    slices_db: np.ndarray,
    db_reference: str,
    dynamic_range_db: float,
) -> np.ndarray:
    """
    Waterfall relative-dB normalisation (reference waterfall.py:289-341):
    subtract the global max (or each slice's own max), clip to [-dyn, 0].
    slices_db: (S, F) absolute dB values of the selected slice frames.
    """
    s = np.asarray(slices_db, dtype=np.float64).copy()
    if str(db_reference).lower() == "slice_max":
        for i in range(s.shape[0]):
            s[i] -= s[i].max()
    else:
        s -= s.max()
    dyn = float(max(10.0, dynamic_range_db))
    return np.clip(s, -dyn, 0.0)


def spectrogram_color_scale(
    mag_db: np.ndarray,
    dynamic_range_db: Optional[float] = 90.0,
) -> Tuple[float, float]:
    """
    Spectrogram colour limits (reference spectrogram.py:278-289):
    vmax = 99.5th percentile; vmin = vmax - dynamic range (or 5th pct).
    """
    vmax = float(np.percentile(np.asarray(mag_db, np.float64), 99.5))
    if dynamic_range_db is not None:
        vmin = vmax - float(dynamic_range_db)
    else:
        vmin = float(np.percentile(np.asarray(mag_db, np.float64), 5.0))
    return vmin, vmax


# ----------------------------------------------------------------------------
# FFT band masks
# ----------------------------------------------------------------------------


def raised_cosine_ramp(x: np.ndarray, x0: float, x1: float) -> np.ndarray:
    if x1 <= x0:
        return (x >= x1).astype(np.float64)
    t = np.clip((x - x0) / (x1 - x0), 0.0, 1.0)
    return 0.5 - 0.5 * np.cos(np.pi * t)


def lowpass_mask(freqs: np.ndarray, pass_hz: float, transition_oct: float, nyquist: float) -> np.ndarray:
    pass_hz = float(np.clip(pass_hz, 1.0, nyquist))
    stop_hz = min(nyquist, pass_hz * 2.0**transition_oct)
    if stop_hz <= pass_hz:
        stop_hz = min(nyquist, pass_hz + 1.0)
    mask = 1.0 - raised_cosine_ramp(freqs, pass_hz, stop_hz)
    mask[freqs <= pass_hz] = 1.0
    mask[freqs >= stop_hz] = 0.0
    return mask


def highpass_mask(freqs: np.ndarray, pass_hz: float, transition_oct: float, nyquist: float) -> np.ndarray:
    pass_hz = float(np.clip(pass_hz, 1.0, nyquist))
    stop_hz = max(1.0, pass_hz / 2.0**transition_oct)
    if pass_hz <= stop_hz:
        stop_hz = max(1.0, pass_hz - 1.0)
    mask = raised_cosine_ramp(freqs, stop_hz, pass_hz)
    mask[freqs <= stop_hz] = 0.0
    mask[freqs >= pass_hz] = 1.0
    return mask


def bandpass_mask(
    freqs: np.ndarray, low_hz: float, high_hz: float, transition_oct: float, nyquist: float
) -> np.ndarray:
    low_hz = float(np.clip(low_hz, 1.0, nyquist))
    high_hz = float(np.clip(high_hz, 1.0, nyquist))
    if high_hz <= low_hz:
        return np.zeros_like(freqs)
    return highpass_mask(freqs, low_hz, transition_oct, nyquist) * lowpass_mask(
        freqs, high_hz, transition_oct, nyquist
    )


def apply_fft_mask(samples: np.ndarray, mask: np.ndarray) -> np.ndarray:
    n = samples.size
    return np.fft.irfft(np.fft.rfft(np.asarray(samples, dtype=np.float64)) * mask, n=n)


# ----------------------------------------------------------------------------
# deconvolution
# ----------------------------------------------------------------------------


def deconvolve(
    recorded_2d: np.ndarray,
    sweep_1d: np.ndarray,
    regularization_relative: float = 1e-10,
) -> np.ndarray:
    """H = Y conj(X) / (|X|^2 + eps); returns (n_recorded, C) float64."""
    y2 = np.asarray(recorded_2d, dtype=np.float64)
    x = np.asarray(sweep_1d, dtype=np.float64)
    n_rec = y2.shape[0]
    n_fft = 1 << int(max(n_rec, x.size) - 1).bit_length()
    X = np.fft.rfft(x, n=n_fft)
    power = np.abs(X) ** 2
    eps = regularization_relative * max(1e-30, float(power.max()))
    denom = power + eps
    out = np.empty((n_rec, y2.shape[1]))
    for ch in range(y2.shape[1]):
        Y = np.fft.rfft(y2[:, ch], n=n_fft)
        h = np.fft.irfft(Y * np.conj(X) / denom, n=n_fft)
        out[:, ch] = h[:n_rec]
    return out


# ----------------------------------------------------------------------------
# diffusion window metrics
# ----------------------------------------------------------------------------


def windowed_max_abs_autocorr(x: np.ndarray, max_lag: int) -> float:
    if x.size < 4:
        return float("nan")
    x0 = np.asarray(x, dtype=np.float64) - np.mean(x)
    denom = float(np.dot(x0, x0))
    if denom <= 1e-20:
        return float("nan")
    best = 0.0
    for lag in range(1, min(max_lag, x0.size - 2) + 1):
        best = max(best, abs(float(np.dot(x0[:-lag], x0[lag:]) / denom)))
    return best


def windowed_echo_density(x: np.ndarray, threshold_rms: float, normalise_to_gaussian: bool) -> float:
    if x.size < 4:
        return float("nan")
    x0 = np.asarray(x, dtype=np.float64) - np.mean(x)
    rms = float(np.sqrt(np.mean(x0 * x0)))
    if rms <= 1e-20:
        return float("nan")
    frac = float(np.mean(np.abs(x0) > threshold_rms * rms))
    if not normalise_to_gaussian:
        return frac
    phi = 0.5 * (1.0 + math.erf(threshold_rms / math.sqrt(2.0)))
    expected = 2.0 * (1.0 - phi)
    return frac / expected if expected > 1e-12 else float("nan")


def windowed_corr0(x: np.ndarray, y: np.ndarray) -> float:
    if x.size != y.size or x.size < 4:
        return float("nan")
    x0 = np.asarray(x, dtype=np.float64) - np.mean(x)
    y0 = np.asarray(y, dtype=np.float64) - np.mean(y)
    xx, yy = float(np.dot(x0, x0)), float(np.dot(y0, y0))
    if xx <= 1e-20 or yy <= 1e-20:
        return float("nan")
    return float(np.dot(x0, y0) / np.sqrt(xx * yy))


def windowed_iacc_max(x: np.ndarray, y: np.ndarray, max_lag: int) -> float:
    if x.size != y.size or x.size < 4:
        return float("nan")
    x0 = np.asarray(x, dtype=np.float64) - np.mean(x)
    y0 = np.asarray(y, dtype=np.float64) - np.mean(y)
    denom = math.sqrt(float(np.dot(x0, x0)) * float(np.dot(y0, y0)))
    if denom <= 1e-20:
        return float("nan")
    L = min(max_lag, x0.size - 2)
    best = abs(float(np.dot(x0, y0) / denom))
    for lag in range(1, L + 1):
        best = max(best, abs(float(np.dot(x0[:-lag], y0[lag:]) / denom)))
        best = max(best, abs(float(np.dot(x0[lag:], y0[:-lag]) / denom)))
    return best


# ----------------------------------------------------------------------------
# AR fit
# ----------------------------------------------------------------------------


def fit_ar_least_squares(x: np.ndarray, order: int, ridge_lambda: float = 0.0) -> np.ndarray:
    """AR coefficients a with a[0] = 1 for x[n] + sum a[k] x[n-k] = e[n]."""
    x = np.asarray(x, dtype=np.float64)
    p = int(order)
    if p < 1:
        return np.array([1.0])
    if x.size <= p:
        p = max(1, x.size - 1)
    N = x.size
    y = -x[p:N]
    A = np.empty((N - p, p))
    for k in range(1, p + 1):
        A[:, k - 1] = x[p - k : N - k]
    if ridge_lambda and ridge_lambda > 0.0:
        ata = A.T @ A
        ata.flat[:: p + 1] += ridge_lambda
        a_rest = np.linalg.solve(ata, A.T @ y)
    else:
        a_rest, *_ = np.linalg.lstsq(A, y, rcond=None)
    return np.concatenate(([1.0], a_rest))
