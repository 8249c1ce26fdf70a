"""K1 (csrc/edc.cu), the Schroeder curve in dB of `rows` signals of `n`
samples: each sample read once and its curve value written once, in
float32; per sample a square, a scan addition, the normalisation and the
dB scale (log10 not counted)."""

from __future__ import annotations

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("benchroofline_peaks", Path(__file__).with_name("peaks.py"))
peaks = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(peaks)


def work(rows: int, n: int, **_) -> tuple:
    """(bytes, float32 operations) of one launch."""
    return rows * n * 4 * 2 + rows * 4, rows * n * 4.0


def bound_s(shape: dict) -> float:
    return peaks.bound_s(*work(**shape))
