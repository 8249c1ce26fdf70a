"""
audio_analysis_tpu/ops/display.py on torch: the 1/128-dB int16 fixed point
in which dB planes reach the host (the spectrogram and frequency-response
planes, the waterfall slices, the pooled display image), the rfft-bin
range of a frequency selection, the waterfall's frame extraction, and the
display-resolution pooling of the spectrogram figure.

The quantisation is kept exactly (round half to even, +-255.99 dB clip):
summary and JSON values, and the figures' pixels, are taken from the
dequantised planes.

`pooled_log_freq_image` max-pools the (C, T, F) dB plane on its device
onto 720 log-frequency rows and at most about 1200 columns, so that only
the image (about 3 MB for a stereo 2^20-sample tap) and two colour
percentiles cross to the host in one int16 copy. Row pooling is a range
maximum over each row's contiguous bin range: a shifted-maximum pyramid
along F (level k holds max(x[i : i + 2^k])), then each row is the maximum
of two pyramid entries, picked by index (two cached int64 index vectors per
key). The JAX package picks them with a one-hot selection matmul instead,
a TPU workaround for gathers that is not ported. Max is exact, so the image
equals the JAX package's to the bit on the same plane.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from audio_analysis_tpu_torch.ops import selectq

# 1/128-dB steps over +-255.99 dB
_DB_SCALE = 128.0
_DB_CLIP = 255.99
# finite stand-in for -inf as the identity of max (masked and padded cells)
_NEG = -3.0e38


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


@functools.lru_cache(maxsize=16)
def _log_row_select(
    n_fft: int, sample_rate_hz: int, i0: int, i1: int, f_min: float, f_max: float, rows: int
):
    """(flat index of each row's first entry (rows,), of its second entry
    (rows,), pyramid levels) into the level-stacked pyramid (levels *
    F_sel). Row ranges as plot.log_frequency_image draws them: log-spaced
    edges, searchsorted, the nearest bin for a row narrower than a bin."""
    freq_sel = _freqs_f32(n_fft, sample_rate_hz)[i0:i1]
    n_sel = freq_sel.size
    edges = np.logspace(np.log10(f_min), np.log10(f_max), rows + 1)
    idx = np.searchsorted(freq_sel, edges).clip(0, n_sel)
    spans = []
    for r in range(rows):
        lo, hi = int(idx[r]), int(idx[r + 1])
        spans.append((min(lo, n_sel - 1), 1) if hi <= lo else (lo, hi - lo))
    levels = max(w for _, w in spans).bit_length()  # k = 0 .. floor(log2(max width))
    first = np.empty(rows, np.int64)
    second = np.empty(rows, np.int64)
    for r, (lo, w) in enumerate(spans):
        k = w.bit_length() - 1  # 2^k <= w < 2^(k+1): two entries cover the range
        first[r] = k * n_sel + lo
        second[r] = k * n_sel + lo + w - (1 << k)
    return first, second, levels


@functools.lru_cache(maxsize=4)
def _row_index_on(key: tuple, device: torch.device):
    first, second, _ = _log_row_select(*key)
    return torch.from_numpy(first).to(device), torch.from_numpy(second).to(device)


def _pooled_image(
    mag_tf: torch.Tensor, num_frames: torch.Tensor, first: torch.Tensor, second: torch.Tensor,
    i0: int, i1: int, rows: int, levels: int, col_pool: int,
) -> torch.Tensor:
    """(C, T'+1, rows) int16: the pooled image, and the two colour
    percentiles in the first two cells of the extra last column."""
    c, t, _f = mag_tf.shape
    x = mag_tf[:, :, i0:i1]
    n_sel = x.shape[-1]
    valid_t = torch.arange(t, device=x.device)[None, :] < num_frames[:, None]  # (C, T)

    # the colour percentiles over the full-resolution valid region
    vmask = valid_t[:, :, None].expand(c, t, n_sel).reshape(c, -1)
    pcts = selectq.masked_percentiles(x.reshape(c, -1), vmask, (99.5, 5.0))  # (C, 2)

    xm = torch.where(valid_t[:, :, None], x, _NEG)
    if col_pool > 1:
        nb = -(-t // col_pool)
        if nb * col_pool > t:
            xm = torch.nn.functional.pad(xm, (0, 0, 0, nb * col_pool - t), value=_NEG)
        xm = xm.reshape(c, nb, col_pool, n_sel).amax(dim=2)
    planes = [xm]
    for lvl in range(1, levels):
        shift = 1 << (lvl - 1)
        prev = planes[-1]
        shifted = torch.nn.functional.pad(prev[:, :, shift:], (0, shift), value=_NEG)
        planes.append(torch.maximum(prev, shifted))
    stack = torch.cat(planes, dim=2)  # (C, T', levels * F_sel)
    image = torch.maximum(stack.index_select(2, first), stack.index_select(2, second))

    extras = torch.zeros((c, 1, rows), dtype=torch.float32, device=x.device)
    extras[:, 0, :2] = pcts
    return quantize_db_i16(torch.cat([image, extras], dim=1))


def pooled_log_freq_image(
    mag_tf: torch.Tensor,
    num_frames_host: np.ndarray,
    n_fft: int,
    sample_rate_hz: int,
    f_min: float,
    f_max: float,
    rows: int = 720,
    cols: int = 1200,
):
    """
    A (C, T, F) dB plane on its device -> host display products, in one
    int16 copy:

      images: per channel a (rows, T_c') float32 dB image (valid columns
              only, transposed for imshow), the max-pooled values of
              plot.log_frequency_image in the 1/128-dB fixed point
      p995, p5: per-channel colour percentiles of the full-resolution
              valid region

    `num_frames_host` are the per-channel valid frame counts. Each
    channel's column pooling follows its own valid count; channels whose
    pooling differs run one call each.
    """
    i0, i1 = freq_selection(n_fft, sample_rate_hz, f_min, f_max)
    key = (int(n_fft), int(sample_rate_hz), i0, i1, float(f_min), float(f_max), int(rows))
    _first, _second, levels = _log_row_select(*key)
    first, second = _row_index_on(key, mag_tf.device)

    nfh = np.asarray(num_frames_host, np.int64)
    pools = [-(-int(v) // cols) if (cols > 0 and int(v) > cols + cols // 2) else 1 for v in nfh]
    nf = torch.from_numpy(nfh).to(mag_tf.device)

    def run(mag_sub, nf_sub, col_pool):
        q = _pooled_image(mag_sub, nf_sub, first, second, i0, i1, int(rows), levels, int(col_pool))
        return dequantize_db_i16(q.cpu().numpy())

    if len(set(pools)) == 1:
        plane = run(mag_tf, nf, pools[0])
        planes = [plane[c] for c in range(plane.shape[0])]
    else:
        planes = [run(mag_tf[c : c + 1], nf[c : c + 1], cp)[0] for c, cp in enumerate(pools)]

    images, p995, p5 = [], [], []
    for c, plane_c in enumerate(planes):
        nvb = max(1, -(-int(nfh[c]) // pools[c]))
        images.append(plane_c[:nvb].T.copy())  # (rows, T_c')
        p995.append(float(plane_c[-1, 0]))
        p5.append(float(plane_c[-1, 1]))
    return images, np.asarray(p995), np.asarray(p5)
