"""K2 (csrc/stft.cu), the magnitude of a Hann-windowed real FFT of every
valid-framing frame of `rows` signals of `n` samples: each sample read
once, each magnitude of the `bins` kept written once, in float32; per
frame 2.5 n_fft log2 n_fft operations for the real transform (half the
5 n log2 n of a complex one), the window's n_fft products and 3 a
magnitude."""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

_spec = importlib.util.spec_from_file_location("benchroofline_peaks", Path(__file__).with_name("peaks.py"))
peaks = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(peaks)


def frames(n: int, n_fft: int, hop: int) -> int:
    return 0 if n < n_fft else 1 + (n - n_fft) // hop


def work(rows: int, n: int, n_fft: int, hop: int, bins: int, **_) -> tuple:
    t = frames(n, n_fft, hop)
    nbytes = rows * n * 4 + rows * t * bins * 4
    flops = rows * t * (2.5 * n_fft * math.log2(n_fft) + n_fft + 3 * bins)
    return nbytes, flops


def bound_s(shape: dict) -> float:
    return peaks.bound_s(*work(**shape))
