"""
FFT-domain filterbank with raised-cosine transitions
(audio_analysis_tpu/ops/fftmask.py): the masks of all bands are one
(bands, F) matrix built on the host with numpy, applied with one batched
forward and one batched inverse transform. With spectrum-crop decimation
a band whose support fits below a coarser Nyquist is inverse-transformed
at N/k from the same forward spectrum.

The numpy table functions are copies of the JAX package's (its module
imports jax); tests hold them bit-identical. The 2^20-point transforms are
torch.fft, as the JAX package leaves them to jnp.fft outside any kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch


@dataclass(frozen=True)
class BandDefinition:
    name: str
    centre_hz: float
    kind: str  # "lowpass" | "bandpass" | "highpass"
    low_edge_hz: Optional[float] = None
    high_edge_hz: Optional[float] = None


# ----------------------------------------------------------------------------
# host-side mask construction (tiny, static per settings)
# ----------------------------------------------------------------------------


def _ramp(freqs: np.ndarray, x0: float, x1: float) -> np.ndarray:
    if x1 <= x0:
        return (freqs >= x1).astype(np.float64)
    t = np.clip((freqs - x0) / (x1 - x0), 0.0, 1.0)
    return 0.5 - 0.5 * np.cos(np.pi * t)


def make_lowpass_mask(
    freqs: np.ndarray, pass_hz: float, transition_oct: float, nyquist_hz: float
) -> np.ndarray:
    pass_hz = float(np.clip(pass_hz, 1.0, nyquist_hz))
    stop_hz = float(min(nyquist_hz, pass_hz * 2.0**transition_oct))
    if stop_hz <= pass_hz:
        stop_hz = min(nyquist_hz, pass_hz + 1.0)
    mask = 1.0 - _ramp(freqs, pass_hz, stop_hz)
    mask[freqs <= pass_hz] = 1.0
    mask[freqs >= stop_hz] = 0.0
    return mask


def make_highpass_mask(
    freqs: np.ndarray, pass_hz: float, transition_oct: float, nyquist_hz: float
) -> np.ndarray:
    pass_hz = float(np.clip(pass_hz, 1.0, nyquist_hz))
    stop_hz = float(max(1.0, pass_hz / 2.0**transition_oct))
    if pass_hz <= stop_hz:
        stop_hz = max(1.0, pass_hz - 1.0)
    mask = _ramp(freqs, stop_hz, pass_hz)
    mask[freqs <= stop_hz] = 0.0
    mask[freqs >= pass_hz] = 1.0
    return mask


def make_bandpass_mask(
    freqs: np.ndarray,
    low_edge_hz: float,
    high_edge_hz: float,
    transition_oct: float,
    nyquist_hz: float,
) -> np.ndarray:
    low_edge_hz = float(np.clip(low_edge_hz, 1.0, nyquist_hz))
    high_edge_hz = float(np.clip(high_edge_hz, 1.0, nyquist_hz))
    if high_edge_hz <= low_edge_hz:
        return np.zeros_like(freqs)
    return make_highpass_mask(freqs, low_edge_hz, transition_oct, nyquist_hz) * make_lowpass_mask(
        freqs, high_edge_hz, transition_oct, nyquist_hz
    )


def build_band_mask_matrix(
    bands: List[BandDefinition],
    num_samples: int,
    sample_rate_hz: int,
    transition_width_octaves: float,
) -> np.ndarray:
    """(bands, F) float32 mask matrix for rfft of length `num_samples`."""
    freqs = np.fft.rfftfreq(num_samples, d=1.0 / float(sample_rate_hz))
    nyquist = 0.5 * float(sample_rate_hz)
    rows = []
    for band in bands:
        if band.kind == "lowpass":
            rows.append(
                make_lowpass_mask(freqs, band.high_edge_hz, transition_width_octaves, nyquist)
            )
        elif band.kind == "highpass":
            rows.append(
                make_highpass_mask(freqs, band.low_edge_hz, transition_width_octaves, nyquist)
            )
        elif band.kind == "bandpass":
            rows.append(
                make_bandpass_mask(
                    freqs, band.low_edge_hz, band.high_edge_hz, transition_width_octaves, nyquist
                )
            )
        else:
            raise ValueError(f"Unknown band kind: {band.kind}")
    return np.stack(rows, axis=0).astype(np.float32)


# ----------------------------------------------------------------------------
# band definition generation (rt60bands.py:183-253 semantics)
# ----------------------------------------------------------------------------


def build_three_band_definitions(
    sample_rate_hz: int,
    low_upper_hz: float = 250.0,
    mid_center_hz: float = 1000.0,
    mid_width_octaves: float = 2.0,
    high_lower_hz: float = 4000.0,
) -> List[BandDefinition]:
    nyquist = 0.5 * float(sample_rate_hz)
    low_upper = float(np.clip(low_upper_hz, 20.0, nyquist))
    mid_center = float(np.clip(mid_center_hz, 20.0, nyquist))
    mid_width = float(max(0.1, mid_width_octaves))
    high_lower = float(np.clip(high_lower_hz, 20.0, nyquist))

    half = 0.5 * mid_width
    mid_low = float(np.clip(mid_center / 2.0**half, 20.0, nyquist))
    mid_high = float(np.clip(mid_center * 2.0**half, 20.0, nyquist))

    return [
        BandDefinition("Low", float(np.sqrt(20.0 * low_upper)), "lowpass", high_edge_hz=low_upper),
        BandDefinition("Mid", mid_center, "bandpass", low_edge_hz=mid_low, high_edge_hz=mid_high),
        BandDefinition(
            "High",
            float(np.sqrt(max(20.0, high_lower) * nyquist)),
            "highpass",
            low_edge_hz=high_lower,
        ),
    ]


def build_fractional_octave_band_definitions(
    sample_rate_hz: int,
    bands_per_octave: int,
    f_min_hz: float = 31.5,
    f_max_hz: float = 16000.0,
) -> List[BandDefinition]:
    """Centres at 1000 * 2^(k/n), edges at fc * 2^(±1/(2n)), clipped to range."""
    nyquist = 0.5 * float(sample_rate_hz)
    f_min = float(max(20.0, min(f_min_hz, nyquist)))
    f_max = float(max(f_min, min(f_max_hz, nyquist)))

    n = float(bands_per_octave)
    step = 2.0 ** (1.0 / n)
    half_band = 2.0 ** (1.0 / (2.0 * n))
    anchor = 1000.0

    k_min = int(np.floor(np.log(f_min / anchor) / np.log(step)))
    k_max = int(np.ceil(np.log(f_max / anchor) / np.log(step)))

    bands: List[BandDefinition] = []
    for k in range(k_min, k_max + 1):
        fc = anchor * step**k
        if fc < f_min or fc > f_max:
            continue
        low = float(np.clip(fc / half_band, 20.0, nyquist))
        high = float(np.clip(fc * half_band, 20.0, nyquist))
        if high <= low:
            continue
        bands.append(
            BandDefinition(f"{int(round(fc))}Hz", float(fc), "bandpass", low, high)
        )
    bands.sort(key=lambda b: b.centre_hz)
    return bands


# ----------------------------------------------------------------------------
# band decimation factors (host-side, from the mask matrix)
# ----------------------------------------------------------------------------


def band_decimation_factors(
    masks: np.ndarray,
    num_samples: int,
    max_factor: int = 64,
    min_length: int = 16384,
) -> tuple:
    """
    Per-band power-of-two decimation factors for the cropped-spectrum
    inverse (`banded_from_spectrum` with decimation > 1).

    A band whose mask support lies entirely below the decimated Nyquist is
    exactly representable at sample rate sr/k: the length-(N/k) inverse of
    the cropped masked spectrum equals the full-rate band signal sampled at
    every k-th instant (the discarded bins are zero). Its energy partial
    sums match the full-rate Schroeder integrals up to windowed
    Riemann/boundary terms that grow about linearly with k, so band EDC +
    decay fits can run on planes k times smaller.

    Constraints per band: mask support bin <= (N/k)/4 (a 2x oversampling
    margin beyond bare representability, which keeps x^2 alias-free on the
    decimated grid), N % k == 0 with N/k even (the packed-stereo mirror
    needs an even length), N/k >= `min_length` (fit resolution), and
    k <= `max_factor`.
    """
    factors = []
    for row in np.asarray(masks):
        nonzero = np.nonzero(row > 0.0)[0]
        support_stop = int(nonzero[-1]) if nonzero.size else 1
        k = 1
        while (
            k * 2 <= max_factor
            and num_samples % (k * 2) == 0
            and num_samples // (k * 2) >= min_length
            and (num_samples // (k * 2)) % 2 == 0
            and support_stop <= (num_samples // (k * 2)) // 4
        ):
            k *= 2
        factors.append(k)
    return tuple(factors)


def crop_half_masks(masks: np.ndarray, num_samples: int, decimation: int) -> np.ndarray:
    """
    Host-side companion of `banded_from_spectrum`: crop the (bands, N/2+1)
    half-spectrum masks to the decimated grid's (bands, M/2+1) and fold in
    the 1/k inverse-length rescale (an inverse at length M = N/k scales by
    1/M where the full-rate inverse scales by 1/N, so dividing the mask by k
    makes the decimated output equal the full-rate band signal's samples).
    """
    m = num_samples // decimation
    return (np.asarray(masks)[:, : m // 2 + 1] / float(decimation)).astype(np.float32)


# ----------------------------------------------------------------------------
# device-side batched application
# ----------------------------------------------------------------------------


def full_band_spectrum(x: torch.Tensor):
    """
    The forward transform shared by every band/decimation group: ("packed",
    fft(L + iR)) for a stereo pair (the second-to-last axis is exactly 2 and
    N is even), else ("real", rfft(x)).

    The masks are real and even (conjugate-symmetric), so filtering
    commutes with the packing: one c2c transform carries both channels.
    """
    n = x.shape[-1]
    if x.ndim >= 2 and x.shape[-2] == 2 and n % 2 == 0:
        return "packed", torch.fft.fft(torch.complex(x[..., 0, :], x[..., 1, :]), dim=-1)
    return "real", torch.fft.rfft(x, dim=-1)


def banded_from_spectrum(
    kind: str,
    spectrum: torch.Tensor,
    masks: torch.Tensor,
    num_samples: int,
    decimation: int = 1,
) -> torch.Tensor:
    """
    Apply (bands, M/2+1) half-spectrum masks (see `crop_half_masks`) to a
    full-signal spectrum from `full_band_spectrum` and inverse-transform at
    length M = num_samples / decimation.

    kind "real":   spectrum (..., N/2+1) -> (..., bands, M)
    kind "packed": spectrum (..., N) c2c of L + iR -> (..., 2, bands, M)

    With decimation > 1 the crop keeps only the bins below the decimated
    Nyquist, which is exact for bands whose mask support fits (see
    `band_decimation_factors`). The filter still sees the full signal (the
    reference filters, then trims); only the inverse grid is coarser.
    """
    m = num_samples // decimation
    if kind == "packed":
        if decimation > 1:
            # the decimated c2c grid: positive frequencies 0..M/2, and the
            # negative ones are the last M/2 - 1 bins of the full spectrum
            spectrum = torch.cat(
                [spectrum[..., : m // 2 + 1], spectrum[..., num_samples - (m // 2 - 1) :]], dim=-1
            )
        # mirror the half mask onto the full grid: mask[M - g] for g > M/2
        masks_full = torch.cat([masks, torch.flip(masks[:, 1:-1], (-1,))], dim=-1)
        z_banded = torch.fft.ifft(spectrum[..., None, :] * masks_full, dim=-1)
        return torch.stack([z_banded.real, z_banded.imag], dim=-3).to(torch.float32)
    banded = spectrum[..., None, : m // 2 + 1] * masks
    return torch.fft.irfft(banded, n=m, dim=-1).to(torch.float32)


def apply_band_masks(x: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """
    x: (..., N) real signal; masks: (bands, F) with F = N//2 + 1.
    Returns (..., bands, N): every band filtered with one batched forward
    and one batched inverse transform (a stereo pair packed as L + iR, see
    `full_band_spectrum`).
    """
    return banded_from_spectrum(*full_band_spectrum(x), masks, x.shape[-1])
