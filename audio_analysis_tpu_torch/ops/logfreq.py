"""
Log-frequency smoothing and binning (audio_analysis_tpu/ops/logfreq.py):
- dB smoothing on a uniform log2(f) grid (frequency_response.py:117-169,
  waterfall.py:140-185): interpolate onto the grid, box average,
  interpolate back, only inside [f_min, f_max];
- geometric log bins of the modal cloud: one (bins, F) row-normalised
  matrix, so each bin's linear-magnitude mean over its rfft rows is a
  single float32 matmul (modalcloud.py:166-207).

The table functions are numpy copies of the JAX package's (its module
imports jax); tests hold them bit-identical.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from audio_analysis_tpu_torch.ops.common import box_smooth_same


def log_grid_for_range(
    freqs_hz: np.ndarray,
    f_min_hz: float,
    f_max_hz: float,
    log_bins_per_octave: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """
    (selection_mask (F,), grid_freqs_hz (G,)) for smoothing over
    [f_min, f_max]: the grid spans the first and last selected rfft bins
    with max(16, bins_per_octave) points per octave (+1 endpoint).
    """
    f_min = float(max(1.0, f_min_hz))
    f_max = float(max(f_min, f_max_hz))
    sel = (freqs_hz >= f_min) & (freqs_hz <= f_max)
    if not np.any(sel):
        return sel, np.zeros((0,), dtype=np.float64)
    f_sel = freqs_hz[sel].astype(np.float64)
    log2_min, log2_max = np.log2(f_sel[0]), np.log2(f_sel[-1])
    bins_per_oct = int(max(16, log_bins_per_octave))
    num = int(max(8, np.ceil((log2_max - log2_min) * bins_per_oct))) + 1
    grid = 2.0 ** np.linspace(log2_min, log2_max, num)
    return sel, grid


def _interp_plan(x: np.ndarray, xp: np.ndarray):
    """Host half of jnp.interp(x, xp, fp) for a fixed float32 (x, xp): the
    bracketing indices (i - 1, i) and the weight delta / dx of every x, in
    jnp.interp's float32 arithmetic, plus the points that clamp to fp[0]
    and fp[-1]."""
    x, xp = x.astype(np.float32), xp.astype(np.float32)
    i = np.clip(np.searchsorted(xp, x, side="right"), 1, xp.size - 1)
    dx = xp[i] - xp[i - 1]
    dx0 = np.abs(dx) <= np.spacing(np.finfo(np.float32).eps)
    w = np.where(dx0, np.float32(0.0), (x - xp[i - 1]) / np.where(dx0, np.float32(1.0), dx))
    return i, w.astype(np.float32), x < xp[0], x > xp[-1]


def _interp(plan, fp: torch.Tensor) -> torch.Tensor:
    """jnp.interp along the last axis of fp with a plan from _interp_plan."""
    i, w, below, above = plan
    dev = fp.device
    i_t = torch.from_numpy(i).to(dev)
    f0 = fp.index_select(-1, i_t - 1)
    f = f0 + torch.from_numpy(w).to(dev) * (fp.index_select(-1, i_t) - f0)
    f = torch.where(torch.from_numpy(below).to(dev), fp[..., :1], f)
    return torch.where(torch.from_numpy(above).to(dev), fp[..., -1:], f)


def smooth_mag_db_log_frequency(
    freqs_hz: np.ndarray,
    mag_db: torch.Tensor,
    f_min_hz: float,
    f_max_hz: float,
    smoothing_log_bins: int,
    log_bins_per_octave: int,
) -> torch.Tensor:
    """
    mag_db: (..., F). Smooth in dB on a uniform log2(f) grid inside
    [f_min, f_max]; everything outside the range is passed through.
    """
    if smoothing_log_bins <= 1:
        return mag_db
    sel, grid = log_grid_for_range(freqs_hz, f_min_hz, f_max_hz, log_bins_per_octave)
    if grid.size == 0:
        return mag_db
    f_sel = freqs_hz[sel].astype(np.float32)
    grid32 = grid.astype(np.float32)
    sel_idx = torch.from_numpy(np.nonzero(sel)[0]).to(mag_db.device)
    on_grid = _interp(_interp_plan(grid32, f_sel), mag_db.index_select(-1, sel_idx))
    smoothed = box_smooth_same(on_grid, int(smoothing_log_bins))
    back = _interp(_interp_plan(f_sel, grid32), smoothed)
    return mag_db.index_copy(-1, sel_idx, back.to(mag_db.dtype))


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


def aggregate_db_to_log_bins(mag_db: torch.Tensor, bin_matrix: torch.Tensor) -> torch.Tensor:
    """
    mag_db: (..., T, F); bin_matrix: (B, F). dB -> linear magnitude ->
    per-bin mean (one float32 matmul; TF32 stays off, see the package
    docstring) -> dB. Returns (..., B, T).
    """
    mag_lin = 10.0 ** (mag_db / 20.0)
    binned = torch.clamp(torch.matmul(mag_lin, bin_matrix.T), min=1e-30)
    return torch.swapaxes(20.0 * torch.log10(binned), -1, -2)
