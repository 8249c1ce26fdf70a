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
percentiles cross to the host in one int16 copy, already in the figure's
(row, column) orientation. Row pooling is a range maximum over each row's
contiguous bin range. `_pooled_image` is the wrapper of kernel K4
(csrc/pool.cu, the Hopper counterpart of the JAX package's compiled
`_pooled_image_dev`): on a CUDA tensor a memset and three launches read
each row's range directly, quantise, and select the colour percentiles
exactly by radix selection on the floats' order-preserving keys; on a CPU
tensor the plain torch version `_pooled_image_plain` builds a
shifted-maximum pyramid along F (level k holds max(x[i : i + 2^k])), takes
each row as the maximum of two pyramid entries, picked by index (two
cached int64 index vectors per key), and sorts for the percentiles
(`selectq.masked_percentiles`). The JAX package picks the entries with a
one-hot selection matmul, a TPU workaround for gathers that is not ported.
Max and the selection are exact, so the image equals the JAX package's
(transposed) to the bit on the same plane.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from audio_analysis_tpu_torch import _build
from audio_analysis_tpu_torch.ops import selectq

POOL_KERNEL = _build.LaunchCounter("pool")

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
    """Inverse of quantize_db_i16, on the host (float32): one pass, each
    int16 cast to float32 and scaled by 2^-7 (exact)."""
    return np.multiply(np.asarray(q), np.float32(1.0 / _DB_SCALE), dtype=np.float32)


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
def _log_row_spans(
    n_fft: int, sample_rate_hz: int, i0: int, i1: int, f_min: float, f_max: float, rows: int
) -> np.ndarray:
    """(rows, 2) int32: each row's bin range (lo, w) within the selection
    [i0, i1). Row ranges as plot.log_frequency_image draws them: log-spaced
    edges, searchsorted, the nearest bin for a row narrower than a bin."""
    freq_sel = _freqs_f32(n_fft, sample_rate_hz)[i0:i1]
    n_sel = freq_sel.size
    edges = np.logspace(np.log10(f_min), np.log10(f_max), rows + 1)
    idx = np.searchsorted(freq_sel, edges).clip(0, n_sel)
    spans = np.empty((rows, 2), np.int32)
    for r in range(rows):
        lo, hi = int(idx[r]), int(idx[r + 1])
        spans[r] = (min(lo, n_sel - 1), 1) if hi <= lo else (lo, hi - lo)
    return spans


@functools.lru_cache(maxsize=16)
def _log_row_select(
    n_fft: int, sample_rate_hz: int, i0: int, i1: int, f_min: float, f_max: float, rows: int
):
    """(flat index of each row's first entry (rows,), of its second entry
    (rows,), pyramid levels) into the level-stacked pyramid (levels *
    F_sel) of the plain version, for the row ranges of _log_row_spans."""
    spans = _log_row_spans(n_fft, sample_rate_hz, i0, i1, f_min, f_max, rows)
    n_sel = i1 - i0
    levels = int(spans[:, 1].max()).bit_length()  # k = 0 .. floor(log2(max width))
    first = np.empty(rows, np.int64)
    second = np.empty(rows, np.int64)
    for r, (lo, w) in enumerate(spans.tolist()):
        k = w.bit_length() - 1  # 2^k <= w < 2^(k+1): two entries cover the range
        first[r] = k * n_sel + lo
        second[r] = k * n_sel + lo + w - (1 << k)
    return first, second, levels


@functools.lru_cache(maxsize=4)
def _row_index_on(key: tuple, device: torch.device):
    first, second, _ = _log_row_select(*key)
    return torch.from_numpy(first).to(device), torch.from_numpy(second).to(device)


@functools.lru_cache(maxsize=4)
def _row_spans_on(key: tuple, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_log_row_spans(*key)).to(device)


def _colour_percentiles(mag_tf: torch.Tensor, valid_t: torch.Tensor, i0: int, i1: int) -> torch.Tensor:
    """(C, 2) float32: the 99.5th and 5th percentiles of each channel's
    selected bins over its valid frames `valid_t` (C, T)."""
    c, t, _f = mag_tf.shape
    x = mag_tf[:, :, i0:i1]
    vmask = valid_t[:, :, None].expand(c, t, i1 - i0).reshape(c, -1)
    return selectq.masked_percentiles(x.reshape(c, -1), vmask, (99.5, 5.0))


def _valid_frames(mag_tf: torch.Tensor, num_frames: torch.Tensor) -> torch.Tensor:
    return torch.arange(mag_tf.shape[1], device=mag_tf.device)[None, :] < num_frames[:, None]  # (C, T)


def _pooled_image_plain(mag_tf: torch.Tensor, num_frames: torch.Tensor, key: tuple, col_pool: int) -> torch.Tensor:
    """The plain torch version of K4: (C, rows, T'+1) int16, the pooled
    image and the two colour percentiles in the first two cells of the
    extra last column, through the shifted-maximum pyramid and a sort."""
    i0, i1, rows = key[2], key[3], key[6]
    first, second = _row_index_on(key, mag_tf.device)
    levels = _log_row_select(*key)[2]
    c, t, _f = mag_tf.shape
    x = mag_tf[:, :, i0:i1]
    n_sel = x.shape[-1]
    valid_t = _valid_frames(mag_tf, num_frames)
    # the colour percentiles over the full-resolution valid region
    pcts = _colour_percentiles(mag_tf, valid_t, i0, i1)

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
    extras[:, 0, :2] = pcts[:, :rows]
    return quantize_db_i16(torch.cat([image, extras], dim=1)).transpose(1, 2).contiguous()


def _pooled_image_cuda(mag_tf: torch.Tensor, num_frames: torch.Tensor, key: tuple, col_pool: int) -> torch.Tensor:
    """Kernel K4 on a CUDA float32 plane: the plain version's output, the
    image and the exact colour percentiles from one memset of its scratch
    and three launches."""
    if mag_tf.device.type != "cuda" or mag_tf.dtype != torch.float32:
        raise TypeError(f"pooling kernel takes a CUDA float32 plane, got {mag_tf.dtype} on {mag_tf.device}")
    i0, i1, rows = key[2], key[3], key[6]
    x = mag_tf.contiguous()
    c, t, f = x.shape
    out = torch.empty((c, rows, -(-t // col_pool) + 1), dtype=torch.int16, device=x.device)
    if c == 0 or rows == 0:
        return out
    nf = num_frames.to(device=x.device, dtype=torch.int64).contiguous()
    spans = _row_spans_on(key, x.device)
    lib = _build.library()
    scratch = torch.empty(lib.aa_pool_scratch_bytes(c), dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.aa_pool_image(
            x.data_ptr(), nf.data_ptr(), spans.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            c, t, f, i0, i1 - i0, rows, int(col_pool), stream,
        )
    _build.check(code, "pool kernel")
    POOL_KERNEL.launches += 1
    return out


def _pooled_image(mag_tf: torch.Tensor, num_frames: torch.Tensor, key: tuple, col_pool: int) -> torch.Tensor:
    """(C, rows, T'+1) int16 pooled image with the colour percentiles in
    its extra last column: kernel K4 on a CUDA plane, the plain version on
    a CPU plane."""
    if mag_tf.device.type == "cuda":
        return _pooled_image_cuda(mag_tf, num_frames, key, col_pool)
    if mag_tf.device.type == "cpu":
        return _pooled_image_plain(mag_tf, num_frames, key, col_pool)
    raise ValueError(f"unsupported device {mag_tf.device}")


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

    nfh = np.asarray(num_frames_host, np.int64)
    pools = [-(-int(v) // cols) if (cols > 0 and int(v) > cols + cols // 2) else 1 for v in nfh]
    nf = torch.from_numpy(nfh).to(mag_tf.device)

    def run(mag_sub, nf_sub, col_pool):
        q = _pooled_image(mag_sub, nf_sub, key, int(col_pool))
        if q.device.type != "cuda":
            return q.numpy()
        # one copy into page-locked memory, which the card writes directly
        # (a pageable copy is staged through a driver buffer)
        host = torch.empty(q.shape, dtype=q.dtype, pin_memory=True)
        host.copy_(q)
        return host.numpy()

    if len(set(pools)) == 1:
        packed = run(mag_tf, nf, pools[0])
        per_channel = [packed[c] for c in range(packed.shape[0])]
    else:
        per_channel = [run(mag_tf[c : c + 1], nf[c : c + 1], cp)[0] for c, cp in enumerate(pools)]

    images, p995, p5 = [], [], []
    for c, q_c in enumerate(per_channel):  # (rows, T_c' + 1) int16
        nvb = max(1, -(-int(nfh[c]) // pools[c]))
        images.append(dequantize_db_i16(q_c[:, :nvb]))  # (rows, T_c')
        p995.append(float(dequantize_db_i16(q_c[0, -1])))
        p5.append(float(dequantize_db_i16(q_c[1, -1])))
    return images, np.asarray(p995), np.asarray(p5)
