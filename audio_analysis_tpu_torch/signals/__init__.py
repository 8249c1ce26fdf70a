"""
Deterministic test-signal generators, the host API of the port
(audio_analysis_tpu/signals/__init__.py): ten generators returning mono
float32 `GeneratedSignal` in [-1, 1], all noise seeded with
np.random.default_rng, so every generator but Karplus-Strong gives the JAX
package's samples bit for bit.

Everything is numpy on the host (signals are at most a few hundred
thousand samples) except the Karplus-Strong recurrence, which runs on a
torch device (signals/torchgen.py, default cuda).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import numpy as np
import torch

WindowType = Literal["rect", "hann", "hamming", "blackman"]
NoiseType = Literal["white", "pink"]


@dataclass(frozen=True)
class GeneratedSignal:
    samples: np.ndarray  # (num_samples,) float32
    sample_rate_hz: int


# ----------------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------------


def seconds_to_samples(duration_seconds: float, sample_rate_hz: int) -> int:
    if duration_seconds < 0.0:
        raise ValueError("Duration must be non-negative")
    return int(round(duration_seconds * sample_rate_hz))


def generate_window(number_of_samples: int, window_type: WindowType = "hann") -> np.ndarray:
    """rect/hann/hamming/blackman windows (signals.py:74-95)."""
    if number_of_samples <= 0:
        return np.zeros((0,), dtype=np.float32)
    if window_type == "rect":
        return np.ones(number_of_samples, dtype=np.float32)
    if window_type == "hann":
        return np.hanning(number_of_samples).astype(np.float32)
    if window_type == "hamming":
        return np.hamming(number_of_samples).astype(np.float32)
    if window_type == "blackman":
        return np.blackman(number_of_samples).astype(np.float32)
    raise ValueError(f"Unknown window type: {window_type}")


def normalise_peak_amplitude(samples: np.ndarray, target_peak: float = 0.95) -> np.ndarray:
    x = np.asarray(samples, dtype=np.float32)
    if x.size == 0:
        return x
    peak = float(np.max(np.abs(x)))
    if peak <= 0.0:
        return x
    return (x * (target_peak / peak)).astype(np.float32)


def convert_to_float32_and_limit_peak(samples: np.ndarray) -> np.ndarray:
    x = np.asarray(samples, dtype=np.float32)
    if x.size == 0:
        return x
    peak = float(np.max(np.abs(x)))
    if peak > 1.0:
        x = (x / peak).astype(np.float32)
    return x


def duplicate_mono_to_stereo(mono_samples: np.ndarray) -> np.ndarray:
    x = np.asarray(mono_samples, dtype=np.float32)
    return np.stack([x, x], axis=1)


def _bandlimited_seeded_noise(n: int, sample_rate_hz: int, cutoff_hz: float, seed: int) -> np.ndarray:
    """Seeded white noise lowpassed by zeroing rFFT bins above cutoff."""
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal(n).astype(np.float32)
    spectrum = np.fft.rfft(noise)
    freqs = np.fft.rfftfreq(n, d=1.0 / sample_rate_hz)
    spectrum[freqs > float(cutoff_hz)] = 0.0
    return np.fft.irfft(spectrum, n=n).astype(np.float32)


# ----------------------------------------------------------------------------
# generators
# ----------------------------------------------------------------------------


def generate_impulse(
    sample_rate_hz: int = 48_000,
    impulse_sample_index: int = 0,
    total_duration_seconds: float = 1.0,
) -> GeneratedSignal:
    """Dirac impulse in a fixed-length buffer (signals.py:121-143)."""
    n = seconds_to_samples(total_duration_seconds, sample_rate_hz)
    x = np.zeros((n,), dtype=np.float32)
    if 0 <= impulse_sample_index < n:
        x[impulse_sample_index] = 1.0
    return GeneratedSignal(x, sample_rate_hz)


def generate_click(
    sample_rate_hz: int = 48_000,
    click_duration_seconds: float = 0.001,
    window_type: WindowType = "hann",
) -> GeneratedSignal:
    """Short windowed pulse (signals.py:146-173)."""
    n = max(1, seconds_to_samples(click_duration_seconds, sample_rate_hz))
    x = normalise_peak_amplitude(generate_window(n, window_type), 0.95)
    return GeneratedSignal(x.astype(np.float32), sample_rate_hz)


def generate_impulse_train(
    sample_rate_hz: int = 48_000,
    total_duration_seconds: float = 2.0,
    impulse_period_seconds: float = 0.25,
    click_duration_seconds: float = 0.001,
    window_type: WindowType = "hann",
) -> GeneratedSignal:
    """Periodic click train (signals.py:176-222)."""
    total = seconds_to_samples(total_duration_seconds, sample_rate_hz)
    period = max(1, seconds_to_samples(impulse_period_seconds, sample_rate_hz))
    click = generate_click(sample_rate_hz, click_duration_seconds, window_type).samples

    out = np.zeros((total,), dtype=np.float32)
    for start in range(0, total, period):
        end = min(total, start + click.size)
        out[start:end] += click[: end - start]
    return GeneratedSignal(normalise_peak_amplitude(out, 0.95), sample_rate_hz)


def generate_noise(
    sample_rate_hz: int = 48_000,
    duration_seconds: float = 1.0,
    noise_type: NoiseType = "white",
    random_seed: int = 0,
) -> GeneratedSignal:
    """Seeded white or pink noise; pink via 1/sqrt(f) rFFT shaping (signals.py:225-285)."""
    n = seconds_to_samples(duration_seconds, sample_rate_hz)
    rng = np.random.default_rng(random_seed)

    if noise_type == "white":
        x = rng.standard_normal(n).astype(np.float32)
        return GeneratedSignal(normalise_peak_amplitude(x, 0.95), sample_rate_hz)

    if noise_type == "pink":
        white = rng.standard_normal(n).astype(np.float32)
        spectrum = np.fft.rfft(white)
        freqs = np.fft.rfftfreq(n, d=1.0 / sample_rate_hz)
        scale = np.ones_like(freqs, dtype=np.float32)
        positive = freqs > 0.0
        scale[positive] = 1.0 / np.sqrt(freqs[positive])
        pink = np.fft.irfft(spectrum * scale, n=n).astype(np.float32)
        pink -= float(np.mean(pink))
        return GeneratedSignal(normalise_peak_amplitude(pink, 0.95), sample_rate_hz)

    raise ValueError(f"Unknown noise type: {noise_type}")


def generate_noise_burst(
    sample_rate_hz: int = 48_000,
    burst_duration_seconds: float = 0.02,
    noise_type: NoiseType = "white",
    random_seed: int = 0,
    window_type: WindowType = "hann",
) -> GeneratedSignal:
    """Short windowed noise burst (signals.py:288-313)."""
    base = generate_noise(sample_rate_hz, burst_duration_seconds, noise_type, random_seed).samples
    x = base * generate_window(base.size, window_type)
    return GeneratedSignal(normalise_peak_amplitude(x, 0.95), sample_rate_hz)


def generate_sine(
    sample_rate_hz: int = 48_000,
    frequency_hz: float = 440.0,
    duration_seconds: float = 2.0,
    amplitude: float = 0.5,
    initial_phase_radians: float = 0.0,
) -> GeneratedSignal:
    """Sustained sine (signals.py:316-345)."""
    n = seconds_to_samples(duration_seconds, sample_rate_hz)
    t = np.arange(n, dtype=np.float32) / float(sample_rate_hz)
    x = amplitude * np.sin(2.0 * np.pi * frequency_hz * t + initial_phase_radians)
    return GeneratedSignal(convert_to_float32_and_limit_peak(x), sample_rate_hz)


def generate_sine_burst(
    sample_rate_hz: int = 48_000,
    frequency_hz: float = 220.0,
    burst_duration_seconds: float = 0.1,
    amplitude: float = 0.7,
    window_type: WindowType = "hann",
) -> GeneratedSignal:
    """Windowed sine burst (signals.py:348-373)."""
    sine = generate_sine(sample_rate_hz, frequency_hz, burst_duration_seconds, amplitude).samples
    x = sine * generate_window(sine.size, window_type)
    return GeneratedSignal(normalise_peak_amplitude(x, 0.95), sample_rate_hz)


def generate_log_sine_sweep(
    sample_rate_hz: int = 48_000,
    duration_seconds: float = 10.0,
    start_frequency_hz: float = 20.0,
    end_frequency_hz: float = 20_000.0,
    amplitude: float = 0.5,
    fade_duration_seconds: float = 0.01,
    pre_silence_seconds: float = 0.0,
    post_silence_seconds: float = 0.0,
) -> GeneratedSignal:
    """
    Exponential (log) sine sweep for deconvolution-based IR extraction.

    Exact exponential phase phi(t) = 2*pi*f0*c*(exp(t/c) - 1) with
    c = T / ln(f1/f0) (signals.py:413-425); half-cosine fades
    (signals.py:434-439); DC removal; optional pre/post silence pads
    (signals.py:444-451).
    """
    n = seconds_to_samples(duration_seconds, sample_rate_hz)
    if n <= 1:
        return GeneratedSignal(np.zeros((n,), dtype=np.float32), sample_rate_hz)
    if start_frequency_hz <= 0.0 or end_frequency_hz <= start_frequency_hz:
        raise ValueError("Require 0 < start_frequency_hz < end_frequency_hz")

    t = np.arange(n, dtype=np.float64) / float(sample_rate_hz)
    c = float(duration_seconds) / np.log(end_frequency_hz / start_frequency_hz)
    phase = 2.0 * np.pi * start_frequency_hz * c * (np.exp(t / c) - 1.0)
    sweep = (amplitude * np.sin(phase)).astype(np.float32)

    fade = min(seconds_to_samples(fade_duration_seconds, sample_rate_hz), n // 2)
    if fade > 0:
        ramp = 0.5 - 0.5 * np.cos(np.linspace(0.0, np.pi, fade, dtype=np.float32))
        sweep[:fade] *= ramp
        sweep[-fade:] *= ramp[::-1]

    sweep -= float(np.mean(sweep))

    pre = seconds_to_samples(pre_silence_seconds, sample_rate_hz)
    post = seconds_to_samples(post_silence_seconds, sample_rate_hz)
    if pre > 0 or post > 0:
        sweep = np.concatenate(
            [np.zeros(pre, dtype=np.float32), sweep, np.zeros(post, dtype=np.float32)]
        )
    return GeneratedSignal(sweep, sample_rate_hz)


def generate_pluck_like(
    sample_rate_hz: int = 48_000,
    duration_seconds: float = 0.15,
    bandlimit_frequency_hz: float = 8000.0,
    decay_time_constant_seconds: float = 0.03,
    random_seed: int = 0,
) -> GeneratedSignal:
    """Band-limited noise under an exponential envelope (signals.py:459-515)."""
    n = seconds_to_samples(duration_seconds, sample_rate_hz)
    if n <= 0:
        return GeneratedSignal(np.zeros((0,), dtype=np.float32), sample_rate_hz)

    noise = _bandlimited_seeded_noise(n, sample_rate_hz, bandlimit_frequency_hz, random_seed)
    t = np.arange(n, dtype=np.float32) / float(sample_rate_hz)
    envelope = np.exp(-t / float(decay_time_constant_seconds)).astype(np.float32)
    return GeneratedSignal(normalise_peak_amplitude(noise * envelope, 0.95), sample_rate_hz)


def generate_karplus_strong_pluck(
    sample_rate_hz: int = 48_000,
    fundamental_frequency_hz: float = 110.0,
    duration_seconds: float = 2.0,
    excitation_noise_bandlimit_hz: float = 8000.0,
    feedback_decay_factor: float = 0.996,
    lowpass_blend: float = 0.5,
    random_seed: int = 0,
    device: "str | torch.device" = "cuda",
) -> GeneratedSignal:
    """
    Karplus-Strong pluck: a delay line seeded with band-limited noise,
    recirculated through a 2-point-average damping blend and a decay
    factor. The recurrence runs in float32 on `device`, one delay-line
    period per step (signals/torchgen.py).
    """
    if fundamental_frequency_hz <= 0.0:
        raise ValueError("fundamental_frequency_hz must be > 0")
    if not (0.0 < feedback_decay_factor < 1.0):
        raise ValueError("feedback_decay_factor must be between 0 and 1 (exclusive)")
    if not (0.0 <= lowpass_blend <= 1.0):
        raise ValueError("lowpass_blend must be between 0 and 1 (inclusive)")

    total = seconds_to_samples(duration_seconds, sample_rate_hz)
    if total <= 0:
        return GeneratedSignal(np.zeros((0,), dtype=np.float32), sample_rate_hz)

    delay_len = max(2, int(round(sample_rate_hz / fundamental_frequency_hz)))
    initial = _bandlimited_seeded_noise(
        delay_len, sample_rate_hz, excitation_noise_bandlimit_hz, random_seed
    )

    from audio_analysis_tpu_torch.signals import torchgen

    out = torchgen.karplus_strong_scan(
        initial_delay_line=torch.from_numpy(initial).to(device),
        total_samples=total,
        feedback_decay_factor=float(feedback_decay_factor),
        lowpass_blend=float(lowpass_blend),
    )
    return GeneratedSignal(normalise_peak_amplitude(out.cpu().numpy(), 0.95), sample_rate_hz)
