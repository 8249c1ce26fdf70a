"""K4 (csrc/pool.cu), the display pooling of a (channels, frames, bins)
STFT magnitude plane onto `rows` log-frequency rows, columns max-pooled by
`col_pool`, with two exact colour percentiles: the selected bins of every
frame read once and the int16 image (its extra column carrying the
percentiles) written once; no arithmetic counted (a maximum and a
comparison per element)."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np

_spec = importlib.util.spec_from_file_location("benchroofline_peaks", Path(__file__).with_name("peaks.py"))
peaks = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(peaks)


def selected_bins(n_fft: int, sample_rate_hz: int, f_min: float, f_max: float) -> int:
    """rfft bins whose float32 frequency lies in [f_min, f_max]."""
    f = np.fft.rfftfreq(n_fft, 1.0 / sample_rate_hz).astype(np.float32)
    return int(((f >= np.float32(f_min)) & (f <= np.float32(f_max))).sum())


def work(channels: int, frames: int, n_sel: int, rows: int, col_pool: int, **_) -> tuple:
    columns = -(-frames // col_pool) + 1
    return channels * frames * n_sel * 4 + channels * rows * columns * 2, 0.0


def bound_s(shape: dict) -> float:
    return peaks.bound_s(*work(**shape))
