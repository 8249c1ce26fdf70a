"""
Schroeder energy decay curve (audio_analysis_tpu/ops/edc.py): backwards-
integrated energy, epsilon floor, 0 dB at the segment start, optional
dB-domain box smoothing, display floor, 0 past the valid length. Batched
over leading dims.

`schroeder_edc_db` is the wrapper of kernel K1 (csrc/edc.cu, the Hopper
counterpart of the TPU kernel ops/pallas_kernels.py:schroeder_edc_db_pallas):
on a CUDA tensor it launches the kernel, on a CPU tensor it runs the plain
torch version `schroeder_edc_db_plain` beside it. Both are held to the
float64 oracle's `oracle.schroeder_edc_db` (with trim_to_peak off) over
rows, lengths, eps and floors: tests/test_torch_oracle.py and
tests/test_torch_fuzz.py on the CPU, chip_smoke.py's fuzz phase and
tests/test_torch_cuda.py on the card.

Row starts. `schroeder_edc_db(x, length, start=s)` is the curve of
`trim.shift_to(x, s, length)`: each row aligned so that its sample
clamp(s, 0, N) lands at index 0, over the aligned length max(length - s, 0)
(the EdcResult's length). On the CPU it runs exactly that, shift_to and
then the plain version. On the card K1 reads each row from its clamped
start, never at or past the aligned length nor past the row's end, so no
shifted copy of the plane is made; its tiles and summation order are keyed
to the aligned index, so the curve is bit-identical to shift_to followed
by K1 without starts. A misaligned start keeps 16-byte loads (csrc/edc.cu,
"Row starts"). `EDC_SHIFTED` counts the K1 launches that read through row
starts.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from audio_analysis_tpu_torch import _build
from audio_analysis_tpu_torch.ops import trim
from audio_analysis_tpu_torch.ops.common import bool_valid_mask, box_smooth_same, db_from_power

EDC_KERNEL = _build.LaunchCounter("edc")
EDC_SHIFTED = _build.LaunchCounter("edc_shifted")


class EdcResult(NamedTuple):
    edc_db: torch.Tensor  # (..., N): 0 dB at index 0, floored, 0 past length
    length: torch.Tensor  # (...,) int32 valid curve samples


def schroeder_edc_db_plain(
    samples: torch.Tensor,
    length: torch.Tensor,
    edc_epsilon: float = 1e-20,
    edc_floor_db: float = -120.0,
    start: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain torch EDC: a reversed cumulative sum (flip/cumsum/flip),
    accumulated tail-first like the reference. With `start`, `length` is
    each row's aligned length, as K1 takes it, and the rows are aligned by
    trim.shift_to first (start + aligned length = max(length, start), from
    which shift_to leaves the aligned length)."""
    if start is not None:
        samples = trim.shift_to(samples, start, start + length).samples
    mask = bool_valid_mask(samples.shape[-1], length)
    energy = torch.where(mask, samples * samples, 0.0)
    edc_linear = torch.flip(torch.cumsum(torch.flip(energy, (-1,)), dim=-1), (-1,))
    edc_linear = torch.clamp(edc_linear, min=edc_epsilon)
    edc_linear = edc_linear / edc_linear[..., :1]
    edc_db = torch.clamp(db_from_power(edc_linear, 0.0), min=edc_floor_db)
    return torch.where(mask, edc_db, 0.0)


def schroeder_edc_db_cuda(
    samples: torch.Tensor,
    length: torch.Tensor,
    edc_epsilon: float = 1e-20,
    edc_floor_db: float = -120.0,
    start: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel K1 on a CUDA float32 tensor (..., N); any N. With `start`,
    each row is read from its start and `length` is its aligned length
    (trim.aligned_length; module docstring)."""
    if samples.device.type != "cuda" or samples.dtype != torch.float32:
        raise TypeError(f"EDC kernel takes a CUDA float32 tensor, got {samples.dtype} on {samples.device}")
    n = samples.shape[-1]
    batch_shape = samples.shape[:-1]
    x = samples.contiguous().reshape(-1, n)
    rows = x.shape[0]

    def per_row(v: torch.Tensor) -> torch.Tensor:
        v = v.to(device=samples.device, dtype=torch.int32)
        return torch.broadcast_to(v, batch_shape).contiguous().reshape(-1)

    lengths = per_row(length)
    starts = None if start is None else per_row(start)
    out = torch.empty_like(x)
    if rows == 0 or n == 0:
        return out.reshape(samples.shape)
    lib = _build.library()
    # scratch: each tile's flagged 64-bit total, then the kernel's ticket
    # counter (zeroed by the C entry on the stream)
    tiles = -(-n // lib.aa_edc_tile_size())
    scratch = torch.empty(2 * rows * tiles + 1, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.aa_edc_db(
            x.data_ptr(), lengths.data_ptr(), None if starts is None else starts.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), rows, n, float(edc_epsilon), float(edc_floor_db), stream,
        )
    _build.check(code, "edc kernel")
    EDC_KERNEL.launches += 1
    if starts is not None:
        EDC_SHIFTED.launches += 1
    return out.reshape(samples.shape)


def schroeder_edc_db(
    samples: torch.Tensor,
    length: torch.Tensor,
    edc_epsilon: float = 1e-20,
    edc_floor_db: float = -120.0,
    smoothing_window_samples: int = 0,
    start: Optional[torch.Tensor] = None,
) -> EdcResult:
    """
    samples: (..., N) analysis segment starting at index 0 (see ops.trim),
    zero past `length`. Returns the EDC in dB with the reference's
    conventions, and the valid length broadcast over the batch dims.

    With `start` (broadcast over the batch dims like `length`), samples is
    the unaligned signal and the result is the curve of
    trim.shift_to(samples, start, length), with the aligned length
    max(length - start, 0) (module docstring).

    A smoothing window > 1 box-filters the unfloored dB curve (masked to 0
    past `length`) before the floor, in the JAX package's order. K1 fuses
    the floor, so it runs with a floor of -inf there; its eps clamp keeps
    the unfloored curve finite.
    """
    smooth = smoothing_window_samples is not None and int(smoothing_window_samples) > 1
    floor_db = -math.inf if smooth else edc_floor_db
    if start is not None:
        length = trim.aligned_length(start, length, samples.shape[:-1])
    if samples.device.type == "cuda":
        edc_db = schroeder_edc_db_cuda(samples, length, edc_epsilon, floor_db, start)
    elif samples.device.type == "cpu":
        edc_db = schroeder_edc_db_plain(samples, length, edc_epsilon, floor_db, start)
    else:
        raise ValueError(f"unsupported device {samples.device}")
    if smooth:
        mask = bool_valid_mask(samples.shape[-1], length)
        edc_db = box_smooth_same(torch.where(mask, edc_db, 0.0), int(smoothing_window_samples))
        edc_db = torch.where(mask, torch.clamp(edc_db, min=edc_floor_db), 0.0)
    length_b = torch.broadcast_to(length.to(torch.int32), samples.shape[:-1])
    return EdcResult(edc_db, length_b)
