"""
The parts of audio_analysis_tpu/ops/display.py that the per-file summaries
depend on: the 1/128-dB int16 fixed point in which dB planes reach the host
(the spectrogram and frequency-response planes, the waterfall slices), the
rfft-bin range of a frequency selection, and the waterfall's frame
extraction.

The quantisation is kept exactly (round half to even, +-255.99 dB clip):
summary and JSON values are taken from the dequantised planes. The
display-resolution pooling of that module belongs to the plot reports and
is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

# 1/128-dB steps over +-255.99 dB
_DB_SCALE = 128.0
_DB_CLIP = 255.99


def quantize_db_i16(x: torch.Tensor) -> torch.Tensor:
    """dB plane -> 1/128-dB int16 fixed point (+-255.99 dB clip), on the
    plane's device."""
    return torch.round(torch.clamp(x, -_DB_CLIP, _DB_CLIP) * _DB_SCALE).to(torch.int16)


def dequantize_db_i16(q) -> np.ndarray:
    """Inverse of quantize_db_i16, on the host (float32)."""
    return np.asarray(q).astype(np.float32) * np.float32(1.0 / _DB_SCALE)


def _freqs_f32(n_fft: int, sample_rate_hz: int) -> np.ndarray:
    """The float32 rfft frequency grid, the dtype the figure code compares
    against (ops.stft.rfft_freqs_hz)."""
    return np.fft.rfftfreq(n_fft, d=1.0 / float(sample_rate_hz)).astype(np.float32)


def freq_selection(n_fft: int, sample_rate_hz: int, f_min: float, f_max: float):
    """The contiguous rfft-bin range [i0, i1) inside [f_min, f_max]."""
    freq = _freqs_f32(n_fft, sample_rate_hz)
    mask = (freq >= np.float32(f_min)) & (freq <= np.float32(f_max))
    if not np.any(mask):
        raise ValueError("empty frequency selection")
    idx = np.nonzero(mask)[0]
    return int(idx[0]), int(idx[-1]) + 1


def stft_frame_slices(
    mag_tf: torch.Tensor,
    frame_idx: np.ndarray,
    n_fft: int,
    sample_rate_hz: int,
    f_min: float,
    f_max: float,
) -> np.ndarray:
    """
    Per-channel STFT frames (C, S, F_sel) of a device (C, T, F) dB plane,
    gathered on the device and fetched as host float32 dB in the 1/128-dB
    fixed point. `frame_idx` is (C, S) (pad rows with a repeated index; the
    caller trims).
    """
    i0, i1 = freq_selection(n_fft, sample_rate_hz, f_min, f_max)
    idx = torch.as_tensor(np.asarray(frame_idx, np.int64), device=mag_tf.device)
    sel = torch.gather(mag_tf[:, :, i0:i1], 1, idx[:, :, None].expand(-1, -1, i1 - i0))
    return dequantize_db_i16(quantize_db_i16(sel).cpu().numpy())
