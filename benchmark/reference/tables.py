"""
Host tables of the engine's analyses, frozen for the benchmark's reference:
the FFT band definitions and their raised-cosine masks (the reference
toolkit's rt60bands.py:116-253) and the modal cloud's geometric log bins
(modalcloud.py:166-207). Plain numpy in float64; nothing here is read from
the program under test.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np


class Band(NamedTuple):
    name: str
    kind: str  # "lowpass" | "bandpass" | "highpass"
    low_hz: Optional[float]
    high_hz: Optional[float]


def three_bands(sr: int, low_upper_hz=250.0, mid_center_hz=1000.0, mid_width_octaves=2.0,
                high_lower_hz=4000.0) -> List[Band]:
    nyq = 0.5 * sr
    low_upper = float(np.clip(low_upper_hz, 20.0, nyq))
    mid_center = float(np.clip(mid_center_hz, 20.0, nyq))
    half = 0.5 * float(max(0.1, mid_width_octaves))
    high_lower = float(np.clip(high_lower_hz, 20.0, nyq))
    return [
        Band("Low", "lowpass", None, low_upper),
        Band("Mid", "bandpass", float(np.clip(mid_center / 2.0**half, 20.0, nyq)),
             float(np.clip(mid_center * 2.0**half, 20.0, nyq))),
        Band("High", "highpass", high_lower, None),
    ]


def fractional_octave_bands(sr: int, per_octave: int, f_min_hz=31.5, f_max_hz=16000.0) -> List[Band]:
    """Centres 1000 * 2^(k/n) inside [f_min, f_max], edges fc * 2^(+-1/(2n))."""
    nyq = 0.5 * sr
    f_min = float(max(20.0, min(f_min_hz, nyq)))
    f_max = float(max(f_min, min(f_max_hz, nyq)))
    step = 2.0 ** (1.0 / per_octave)
    half = 2.0 ** (1.0 / (2.0 * per_octave))
    k_min = int(np.floor(np.log(f_min / 1000.0) / np.log(step)))
    k_max = int(np.ceil(np.log(f_max / 1000.0) / np.log(step)))
    bands = []
    for k in range(k_min, k_max + 1):
        fc = 1000.0 * step**k
        if fc < f_min or fc > f_max:
            continue
        low, high = float(np.clip(fc / half, 20.0, nyq)), float(np.clip(fc * half, 20.0, nyq))
        if high > low:
            bands.append(Band(f"{int(round(fc))}Hz", "bandpass", low, high))
    return bands


def bands_for(mode: str, sr: int) -> List[Band]:
    if mode == "three":
        return three_bands(sr)
    if mode in ("octave", "third"):
        return fractional_octave_bands(sr, 1 if mode == "octave" else 3)
    raise ValueError(f"unknown band mode {mode!r}")


def _ramp(f, x0, x1):
    if x1 <= x0:
        return (f >= x1).astype(np.float64)
    t = np.clip((f - x0) / (x1 - x0), 0.0, 1.0)
    return 0.5 - 0.5 * np.cos(np.pi * t)


def _lowpass(f, pass_hz, oct_, nyq):
    pass_hz = float(np.clip(pass_hz, 1.0, nyq))
    stop = min(nyq, pass_hz * 2.0**oct_)
    if stop <= pass_hz:
        stop = min(nyq, pass_hz + 1.0)
    m = 1.0 - _ramp(f, pass_hz, stop)
    m[f <= pass_hz] = 1.0
    m[f >= stop] = 0.0
    return m


def _highpass(f, pass_hz, oct_, nyq):
    pass_hz = float(np.clip(pass_hz, 1.0, nyq))
    stop = max(1.0, pass_hz / 2.0**oct_)
    if pass_hz <= stop:
        stop = max(1.0, pass_hz - 1.0)
    m = _ramp(f, stop, pass_hz)
    m[f <= stop] = 0.0
    m[f >= pass_hz] = 1.0
    return m


def band_masks(bands: List[Band], n: int, sr: int, transition_octaves: float = 1.0 / 6.0) -> np.ndarray:
    """(bands, n // 2 + 1) float64 masks of an n-point real FFT."""
    f = np.fft.rfftfreq(n, 1.0 / sr)
    nyq = 0.5 * sr
    rows = []
    for b in bands:
        if b.kind == "lowpass":
            rows.append(_lowpass(f, b.high_hz, transition_octaves, nyq))
        elif b.kind == "highpass":
            rows.append(_highpass(f, b.low_hz, transition_octaves, nyq))
        else:
            lo, hi = float(np.clip(b.low_hz, 1.0, nyq)), float(np.clip(b.high_hz, 1.0, nyq))
            rows.append(np.zeros_like(f) if hi <= lo else
                        _highpass(f, lo, transition_octaves, nyq) * _lowpass(f, hi, transition_octaves, nyq))
    return np.stack(rows)


def modal_bins(n_fft: int, sr: int, f_min_hz=20.0, f_max_hz=20000.0, per_octave=24, min_bins=24):
    """(matrix (bins, k_out) of row-normalised means, nonempty (bins,), k_out):
    geometric log bins over [f_min, f_max], cut at the last rfft column any
    bin uses."""
    freq = np.fft.rfftfreq(n_fft, 1.0 / sr)
    nyq = 0.5 * sr
    f_min = float(np.clip(f_min_hz, 1.0, nyq))
    f_max = float(np.clip(f_max_hz, f_min, nyq))
    octaves = float(np.log2(max(f_min * 1.001, f_max) / f_min))
    count = int(max(min_bins, np.ceil(octaves * float(max(4, per_octave)))))
    edges = f_min * 2.0 ** np.linspace(0.0, octaves, count + 1)
    inside = (freq >= f_min) & (freq <= f_max)
    mat = np.zeros((count, freq.size))
    for b in range(count):
        sel = inside & (freq >= edges[b]) & (freq < edges[b + 1])
        if sel.any():
            mat[b, sel] = 1.0 / sel.sum()
    k_out = int(np.nonzero(mat.any(axis=0))[0][-1]) + 1
    return mat[:, :k_out], mat.any(axis=1), k_out


def padded_length(n: int, multiple: int = 4096) -> int:
    """The bundle decoder's padded bucket: every tap zero-padded to the
    longest tap rounded up to `multiple` samples. The engine filters bands
    and transforms FR and group delay over this padded length (a documented
    divergence from the per-file reference, docs/MIGRATION.md)."""
    return -(-int(n) // multiple) * multiple
