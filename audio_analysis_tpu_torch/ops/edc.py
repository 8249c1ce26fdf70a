"""
Schroeder energy decay curve (audio_analysis_tpu/ops/edc.py): backwards-
integrated energy, epsilon floor, 0 dB at the segment start, display floor,
0 past the valid length. Batched over leading dims.

`schroeder_edc_db` is the wrapper of kernel K1 (csrc/edc.cu, the Hopper
counterpart of the TPU kernel ops/pallas_kernels.py:schroeder_edc_db_pallas):
on a CUDA tensor it launches the kernel, on a CPU tensor it runs the plain
torch version `schroeder_edc_db_plain` beside it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from audio_analysis_tpu_torch import _build
from audio_analysis_tpu_torch.ops.common import bool_valid_mask, db_from_power

EDC_KERNEL = _build.LaunchCounter("edc")


class EdcResult(NamedTuple):
    edc_db: torch.Tensor  # (..., N): 0 dB at index 0, floored, 0 past length
    length: torch.Tensor  # (...,) int32 valid curve samples


def schroeder_edc_db_plain(
    samples: torch.Tensor,
    length: torch.Tensor,
    edc_epsilon: float = 1e-20,
    edc_floor_db: float = -120.0,
) -> torch.Tensor:
    """The plain torch EDC: a reversed cumulative sum (flip/cumsum/flip),
    accumulated tail-first like the reference."""
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
) -> torch.Tensor:
    """Kernel K1 on a CUDA float32 tensor (..., N); any N."""
    if samples.device.type != "cuda" or samples.dtype != torch.float32:
        raise TypeError(f"EDC kernel takes a CUDA float32 tensor, got {samples.dtype} on {samples.device}")
    n = samples.shape[-1]
    batch_shape = samples.shape[:-1]
    x = samples.contiguous().reshape(-1, n)
    rows = x.shape[0]
    lengths = (
        torch.broadcast_to(length.to(device=samples.device, dtype=torch.int32), batch_shape)
        .contiguous()
        .reshape(-1)
    )
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
            x.data_ptr(), lengths.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            rows, n, float(edc_epsilon), float(edc_floor_db), stream,
        )
    _build.check(code, "edc kernel")
    EDC_KERNEL.launches += 1
    return out.reshape(samples.shape)


def schroeder_edc_db(
    samples: torch.Tensor,
    length: torch.Tensor,
    edc_epsilon: float = 1e-20,
    edc_floor_db: float = -120.0,
) -> EdcResult:
    """
    samples: (..., N) analysis segment starting at index 0 (see ops.trim),
    zero past `length`. Returns the EDC in dB with the reference's
    conventions, and the valid length broadcast over the batch dims.
    """
    if samples.device.type == "cuda":
        edc_db = schroeder_edc_db_cuda(samples, length, edc_epsilon, edc_floor_db)
    elif samples.device.type == "cpu":
        edc_db = schroeder_edc_db_plain(samples, length, edc_epsilon, edc_floor_db)
    else:
        raise ValueError(f"unsupported device {samples.device}")
    length_b = torch.broadcast_to(length.to(torch.int32), samples.shape[:-1])
    return EdcResult(edc_db, length_b)
