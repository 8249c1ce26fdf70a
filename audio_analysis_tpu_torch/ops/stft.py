"""
Batched STFT magnitude (audio_analysis_tpu/ops/stft.py): "valid" framing
T = 1 + (N - n_fft)//hop, symmetric Hann window, magnitude floored at
`floor_lin`, frames past the valid length zeroed, frame times at the window
start.

`stft_magnitude` is the wrapper of kernel K2 (csrc/stft.cu, the Hopper
counterpart of the TPU kernel ops/pallas_stft.py:stft_magnitude_pallas): on
a CUDA tensor it launches the kernel, on a CPU tensor it runs the plain
torch version `stft_magnitude_plain` beside it (unfold x window -> rfft ->
abs). K2 takes the power-of-two n_fft from 256 to 16384; any other n_fft
(the JAX package and the reference take any size, e.g. --n_fft 3000) goes
through `stft_magnitude_plain` on the tensor's own device. That route is
chosen from n_fft alone, before any launch; a failure of K2 at one of its
own sizes raises. The JAX package's matmul FFT (ops/mxfft.py) exists for
the TPU's matrix unit and has no counterpart here. `stft_magnitude_plain`
and K2 are held to the float64 oracle's `oracle.stft_magnitude_db` (its
magnitude before the dB step) over every n_fft, hop, k_out, floor and
window: tests/test_torch_oracle.py and tests/test_torch_fuzz.py on the CPU,
chip_smoke.py's fuzz phase and tests/test_torch_cuda.py on the card.

`stft_mag_db` is the per-file analyses' dB plane: K2 with the dB floor as
its linear floor and every bin, then 20 log10, invalid frames at the floor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from audio_analysis_tpu_torch import _build
from audio_analysis_tpu_torch.ops.common import db_from_magnitude, device_cache

STFT_KERNEL = _build.LaunchCounter("stft")

MIN_N_FFT = 256
MAX_N_FFT = 16384


class StftResult(NamedTuple):
    mag_db: torch.Tensor  # (..., T, F) float32, dB; invalid frames at floor_db
    num_frames: torch.Tensor  # (...,) int32 frames fully inside the valid length


class StftLinearResult(NamedTuple):
    mag: torch.Tensor  # (..., T, F) float32, LINEAR magnitude (not dB)
    num_frames: torch.Tensor  # (...,) int32 frames fully inside the valid length


def num_frames_static(n: int, n_fft: int, hop: int) -> int:
    if n < n_fft:
        return 0
    return 1 + (n - n_fft) // hop


def frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(..., N) -> (..., T, n_fft) "valid" framing, a strided view."""
    if num_frames_static(x.shape[-1], n_fft, hop) <= 0:
        return x.new_zeros(x.shape[:-1] + (0, n_fft))
    return x.unfold(-1, n_fft, hop)


def hann_window(n_fft: int) -> np.ndarray:
    """Symmetric Hann, identical to np.hanning(n_fft)."""
    return np.hanning(n_fft).astype(np.float32)


def frame_times_seconds(t: int, hop: int, sample_rate_hz: int) -> np.ndarray:
    """Host-side frame-start times (spectrogram.py:158)."""
    return (np.arange(t, dtype=np.float32) * hop / float(sample_rate_hz)).astype(np.float32)


def rfft_freqs_hz(n_fft: int, sample_rate_hz: int) -> np.ndarray:
    return np.fft.rfftfreq(n_fft, d=1.0 / float(sample_rate_hz)).astype(np.float32)


@device_cache(maxsize=16)
def _window(n_fft: int, use_hann_window: bool, device: torch.device) -> torch.Tensor:
    w = hann_window(n_fft) if use_hann_window else np.ones(n_fft, np.float32)
    return torch.from_numpy(w).to(device)


@device_cache(maxsize=16)
def _twiddle(n_fft: int, device: torch.device) -> torch.Tensor:
    """exp(-2 pi i k / n_fft) for k in [0, n_fft/2], computed in float64 and
    rounded to complex64."""
    k = np.arange(n_fft // 2 + 1)
    tw = np.exp(-2j * np.pi * k / n_fft).astype(np.complex64)
    return torch.from_numpy(tw).to(device)


def _frame_valid(t: int, hop: int, n_fft: int, length: torch.Tensor) -> torch.Tensor:
    starts = torch.arange(t, dtype=torch.int32, device=length.device) * hop
    return starts + n_fft <= length[..., None]


def stft_magnitude_plain(
    x: torch.Tensor,
    length: torch.Tensor,
    n_fft: int,
    hop: int,
    use_hann_window: bool = True,
    floor_lin: float = 0.0,
    k_out: Optional[int] = None,
) -> torch.Tensor:
    """(..., N) -> (..., T, k_out): floored |rfft(window * frame)|, frames
    past the valid length zeroed. With no frame (N < n_fft) the plane is
    empty, as K2's."""
    if num_frames_static(x.shape[-1], n_fft, hop) == 0:
        k = n_fft // 2 + 1 if k_out is None else max(0, min(int(k_out), n_fft // 2 + 1))
        return x.new_zeros(x.shape[:-1] + (0, k))
    frames = frame_signal(x, n_fft, hop) * _window(n_fft, use_hann_window, x.device)
    mag = torch.abs(torch.fft.rfft(frames, dim=-1))
    if k_out is not None:
        mag = mag[..., :k_out]
    mag = torch.clamp(mag, min=floor_lin)
    valid = _frame_valid(mag.shape[-2], hop, n_fft, length)
    return torch.where(valid[..., None], mag, 0.0)


def stft_magnitude_cuda(
    x: torch.Tensor,
    length: torch.Tensor,
    n_fft: int,
    hop: int,
    use_hann_window: bool = True,
    floor_lin: float = 0.0,
    k_out: Optional[int] = None,
) -> torch.Tensor:
    """Kernel K2 on a CUDA float32 tensor: the same result as
    `stft_magnitude_plain`, framing, window, FFT, magnitude, floor and
    frame mask in one launch."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise TypeError(f"STFT kernel takes a CUDA float32 tensor, got {x.dtype} on {x.device}")
    _check_n_fft(n_fft)
    if hop <= 0:
        raise ValueError(f"hop must be positive, got {hop}")
    n = x.shape[-1]
    batch_shape = x.shape[:-1]
    f_bins = n_fft // 2 + 1
    k = f_bins if k_out is None else max(0, min(int(k_out), f_bins))
    t = num_frames_static(n, n_fft, hop)
    xf = x.contiguous().reshape(-1, n)
    rows = xf.shape[0]
    out = torch.empty((rows, t, k), dtype=torch.float32, device=x.device)
    if rows == 0 or t == 0 or k == 0:
        return out.reshape(batch_shape + (t, k))
    lengths = (
        torch.broadcast_to(length.to(device=x.device, dtype=torch.int32), batch_shape)
        .contiguous()
        .reshape(-1)
    )
    window = _window(n_fft, use_hann_window, x.device)
    twiddle = _twiddle(n_fft, x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.aa_stft_mag(
            xf.data_ptr(), lengths.data_ptr(), window.data_ptr(), twiddle.data_ptr(),
            out.data_ptr(), rows, n, n_fft, hop, t, k, float(floor_lin), stream,
        )
    _build.check(code, "stft kernel")
    STFT_KERNEL.launches += 1
    return out.reshape(batch_shape + (t, k))


def kernel_takes(n_fft: int) -> bool:
    """Whether K2 has an instance for this n_fft: a power of two from
    MIN_N_FFT to MAX_N_FFT."""
    return MIN_N_FFT <= n_fft <= MAX_N_FFT and not n_fft & (n_fft - 1)


def _check_n_fft(n_fft: int) -> None:
    if not kernel_takes(n_fft):
        raise ValueError(
            f"the STFT kernel takes powers of two from {MIN_N_FFT} to {MAX_N_FFT}, got n_fft={n_fft}"
        )


def stft_magnitude(
    x: torch.Tensor,
    length: torch.Tensor,
    n_fft: int,
    hop: int,
    use_hann_window: bool = True,
    floor_lin: float = 0.0,
    k_out: Optional[int] = None,
) -> StftLinearResult:
    """
    Linear-magnitude STFT: |rfft(window * frame)| floored at `floor_lin`,
    invalid frames zeroed; `k_out` keeps only the first k_out bins.
    Consumers that aggregate in linear magnitude convert to dB once after
    aggregation.
    """
    if x.device.type == "cuda" and kernel_takes(n_fft):
        mag = stft_magnitude_cuda(x, length, n_fft, hop, use_hann_window, floor_lin, k_out)
    elif x.device.type in ("cuda", "cpu"):
        mag = stft_magnitude_plain(x, length, n_fft, hop, use_hann_window, floor_lin, k_out)
    else:
        raise ValueError(f"unsupported device {x.device}")
    valid = _frame_valid(mag.shape[-2], hop, n_fft, length)
    return StftLinearResult(mag, valid.sum(dim=-1, dtype=torch.int32))


def stft_mag_db(
    x: torch.Tensor,
    length: torch.Tensor,
    n_fft: int,
    hop: int,
    use_hann_window: bool = True,
    floor_db: float = -120.0,
) -> StftResult:
    """
    x: (..., N) analysis segment starting at index 0, zeros past `length`.
    Returns mag_db (..., T, F) = 20 log10(max(|STFT|, 10^(floor_db/20)))
    with frames past the valid region set to floor_db, and the valid frame
    count (audio_analysis_tpu/ops/stft.py:stft_mag_db).
    """
    res = stft_magnitude(x, length, n_fft, hop, use_hann_window, 10.0 ** (floor_db / 20.0))
    valid = _frame_valid(res.mag.shape[-2], hop, n_fft, length)
    mag_db = torch.where(valid[..., None], db_from_magnitude(res.mag, floor_db), floor_db)
    return StftResult(mag_db, res.num_frames)
