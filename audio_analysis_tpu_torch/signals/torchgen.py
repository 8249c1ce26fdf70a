"""
Device-side signal generation (audio_analysis_tpu/signals/jaxgen.py), on
an explicit torch device:

- karplus_strong_scan / karplus_strong_batch: the Karplus-Strong feedback
  loop in float32, one delay-line period per vector step;
- log_sine_sweep: the exponential-phase sweep, float32 elementwise;
- synthetic_reverb_ir_batch: batches of decaying-noise IRs with known
  low- and high-band RT60s, from an explicit torch.Generator
  (synthetic_reverb_ir_from_noise shapes given noise).
"""

from __future__ import annotations

import math

import torch


def karplus_strong_batch(
    initial_delay_lines: torch.Tensor,  # (B, L)
    total_samples: int,
    feedback_decay_factor: float,
    lowpass_blend: float,
) -> torch.Tensor:
    """
    (B, total_samples) float32 outputs of B same-pitch strings on the
    device of `initial_delay_lines`. With out[0:L] the initial delay line
    and out[-1] its last sample, the loop is

        out[n + L] = g * ((1 - b) * out[n] + b * (0.5 * (out[n - 1] + out[n])))

    so each period of L outputs is one vector step over the period before
    it (about total / L steps, not total). The operations and their order
    are the per-sample scan's, in float32, so the samples are the same.
    """
    x = initial_delay_lines.to(torch.float32)
    batch, delay_len = x.shape
    total = int(total_samples)
    periods = max(1, -(-total // delay_len))
    # buf[:, 1 + n] = out[n]; buf[:, 0] = out[-1]
    buf = torch.empty((batch, 1 + periods * delay_len), dtype=torch.float32, device=x.device)
    buf[:, 0] = x[:, -1]
    buf[:, 1 : 1 + delay_len] = x
    g = torch.tensor(feedback_decay_factor, dtype=torch.float32, device=x.device)
    b = torch.tensor(lowpass_blend, dtype=torch.float32, device=x.device)
    one_minus_b = 1.0 - b
    for k in range(1, periods):
        lo = (k - 1) * delay_len
        prev = buf[:, lo : lo + delay_len]
        cur = buf[:, lo + 1 : lo + 1 + delay_len]
        two_point_average = 0.5 * (prev + cur)
        filtered = one_minus_b * cur + b * two_point_average
        torch.mul(g, filtered, out=buf[:, lo + 1 + delay_len : lo + 1 + 2 * delay_len])
    return buf[:, 1 : 1 + total]


def karplus_strong_scan(
    initial_delay_line: torch.Tensor,  # (L,)
    total_samples: int,
    feedback_decay_factor: float,
    lowpass_blend: float,
) -> torch.Tensor:
    """The Karplus-Strong recurrence of one string: (total_samples,)."""
    return karplus_strong_batch(
        initial_delay_line[None, :], total_samples, feedback_decay_factor, lowpass_blend
    )[0]


def log_sine_sweep(
    num_samples: int,
    sample_rate_hz: int,
    start_frequency_hz: float,
    end_frequency_hz: float,
    amplitude: float,
    device: "str | torch.device" = "cuda",
) -> torch.Tensor:
    """Exponential-phase log sweep, float32:
    phase = 2 pi f0 c (exp(t / c) - 1), c = T / ln(f1 / f0)."""
    f0 = torch.tensor(start_frequency_hz, dtype=torch.float32, device=device)
    f1 = torch.tensor(end_frequency_hz, dtype=torch.float32, device=device)
    t = torch.arange(num_samples, dtype=torch.float32, device=device) / float(sample_rate_hz)
    c = (num_samples / float(sample_rate_hz)) / torch.log(f1 / f0)
    phase = 2.0 * math.pi * f0 * c * (torch.exp(t / c) - 1.0)
    return amplitude * torch.sin(phase)


def synthetic_reverb_ir_from_noise(
    noise: torch.Tensor,  # (batch, 2, num_samples) standard normal
    sample_rate_hz: int,
    rt60_low_s: float,
    rt60_high_s: float,
    crossover_hz: float = 2000.0,
    direct_peak: float = 1.0,
    onset_samples: int = 256,
) -> torch.Tensor:
    """
    Stereo "verb" IRs with analytically known band RT60s from given noise:
    a direct impulse at `onset_samples` plus 0.05 x the noise split at
    `crossover_hz` (4th-order magnitude lowpass in the rfft domain), the low
    band decaying as 10^(-3 t / rt60_low), the high band as
    10^(-3 t / rt60_high); zero before the onset.
    """
    num_samples = noise.shape[-1]
    device = noise.device
    t = torch.arange(num_samples, dtype=torch.float32, device=device) / float(sample_rate_hz)
    freqs = torch.fft.rfftfreq(num_samples, d=1.0 / float(sample_rate_hz), device=device).to(torch.float32)
    lowpass = 1.0 / (1.0 + (freqs / crossover_hz) ** 4)
    low = torch.fft.irfft(torch.fft.rfft(noise, dim=-1) * lowpass, n=num_samples, dim=-1)
    high = noise - low
    env_low = 10.0 ** (-3.0 * t / rt60_low_s)
    env_high = 10.0 ** (-3.0 * t / rt60_high_s)
    tail = 0.05 * (low * env_low + high * env_high)
    onset = torch.zeros(num_samples, dtype=torch.float32, device=device)
    onset[onset_samples] = direct_peak
    pre_mask = (torch.arange(num_samples, device=device) >= onset_samples).to(torch.float32)
    return (tail + onset) * pre_mask


def synthetic_reverb_ir_batch(
    generator: torch.Generator,
    batch: int,
    num_samples: int,
    sample_rate_hz: int,
    rt60_low_s: float,
    rt60_high_s: float,
    crossover_hz: float = 2000.0,
    direct_peak: float = 1.0,
    onset_samples: int = 256,
) -> torch.Tensor:
    """(batch, 2, num_samples) float32 IRs on the generator's device, from
    its standard normal noise (synthetic_reverb_ir_from_noise)."""
    noise = torch.randn(
        (batch, 2, num_samples), generator=generator, dtype=torch.float32, device=generator.device
    )
    return synthetic_reverb_ir_from_noise(
        noise, sample_rate_hz, rt60_low_s, rt60_high_s, crossover_hz, direct_peak, onset_samples
    )
