"""
Geometric log-frequency bins of the modal cloud (audio_analysis_tpu/ops/
logfreq.py): one (bins, F) row-normalised matrix, so each bin's
linear-magnitude mean over its rfft rows is a single matmul
(modalcloud.py:166-207). Numpy copies of the JAX package's table functions (its
module imports jax); tests hold them bit-identical.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def build_log_bin_edges(
    f_min_hz: float, f_max_hz: float, bins_per_octave: int, min_bins: int
) -> np.ndarray:
    """(B+1,) geometric edges: max(min_bins, ceil(octaves * bins/oct)) bins."""
    f_min = float(max(1.0, f_min_hz))
    f_max = float(max(f_min * 1.001, f_max_hz))
    octaves = float(np.log2(f_max / f_min))
    n = int(max(min_bins, np.ceil(octaves * float(max(4, bins_per_octave)))))
    return (f_min * 2.0 ** np.linspace(0.0, octaves, n + 1)).astype(np.float64)


def build_log_bin_matrix(
    freqs_hz: np.ndarray, edges_hz: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """
    Returns (centres (B,), A (B, F) row-normalised mean matrix,
    bin_nonempty (B,) bool).
    """
    centres = np.sqrt(edges_hz[:-1] * edges_hz[1:]).astype(np.float32)
    num_bins = centres.size
    a = np.zeros((num_bins, freqs_hz.size), dtype=np.float32)
    nonempty = np.zeros(num_bins, dtype=bool)
    for b in range(num_bins):
        sel = (freqs_hz >= edges_hz[b]) & (freqs_hz < edges_hz[b + 1])
        count = int(np.sum(sel))
        if count:
            a[b, sel] = 1.0 / count
            nonempty[b] = True
    return centres, a, nonempty


def modal_bin_matrix(config) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(centres, (bins, modal_n_fft/2+1) matrix, nonempty) of the engine's
    modal block (audio_analysis_tpu/engine/batch.py _modal_bin_matrix)."""
    freq = np.fft.rfftfreq(config.modal_n_fft, 1.0 / config.sample_rate_hz)
    nyquist = 0.5 * config.sample_rate_hz
    f_min = float(np.clip(config.f_min_hz, 1.0, nyquist))
    f_max = float(np.clip(config.f_max_hz, f_min, nyquist))
    fsel = (freq >= f_min) & (freq <= f_max)
    edges = build_log_bin_edges(
        f_min, f_max, config.modal_log_bins_per_octave, config.modal_min_bins
    )
    centres, mat_sel, nonempty = build_log_bin_matrix(freq[fsel], edges)
    mat = np.zeros((centres.size, freq.size), dtype=np.float32)
    mat[:, fsel] = mat_sel
    return centres, mat, nonempty
