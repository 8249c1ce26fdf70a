"""
Analysis-time alignment (audio_analysis_tpu/ops/trim.py): the signal is
shifted so the analysis start lands at index 0 of the same static buffer,
with the new valid length alongside; samples past it are zero.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from audio_analysis_tpu_torch.ops.common import bool_valid_mask


class AlignedSignal(NamedTuple):
    samples: torch.Tensor  # (..., N) analysis segment at index 0, zero past length
    length: torch.Tensor  # (...,) int32 valid samples of the segment
    start_index: torch.Tensor  # (...,) int32 offset into the original signal


def peak_index(x: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Index of the first absolute maximum within the valid prefix (int32)."""
    mask = bool_valid_mask(x.shape[-1], length)
    mag = torch.where(mask, torch.abs(x), -1.0)
    return torch.argmax(mag, dim=-1).to(torch.int32)


def aligned_length(start: torch.Tensor, length: torch.Tensor, batch_shape) -> torch.Tensor:
    """The valid length `shift_to` leaves, max(length - start, 0), with
    `start` and `length` broadcast over `batch_shape` (int32)."""
    return torch.clamp(
        torch.broadcast_to(length.to(torch.int32), batch_shape)
        - torch.broadcast_to(start.to(torch.int32), batch_shape),
        min=0,
    )


def shift_to(x: torch.Tensor, start: torch.Tensor, length: torch.Tensor) -> AlignedSignal:
    """
    Shift x so original index `start` (clipped to [0, N]) lands at 0;
    positions past the end read zero. `start` and `length` broadcast over
    the batch dims; the new length is max(length - start, 0). One gather.
    """
    n = x.shape[-1]
    batch_shape = x.shape[:-1]
    start_b = torch.broadcast_to(start.to(torch.int32), batch_shape)
    src = torch.clamp(start_b, 0, n).to(torch.int64)[..., None] + torch.arange(
        n, device=x.device
    )
    in_range = src < n
    shifted = torch.gather(x, -1, torch.where(in_range, src, 0))
    new_length = aligned_length(start_b, length, batch_shape)
    keep = in_range & bool_valid_mask(n, new_length)
    return AlignedSignal(torch.where(keep, shifted, 0.0), new_length, start_b)


def align_for_analysis(
    x: torch.Tensor,
    length: torch.Tensor,
    sample_rate_hz: int,
    trim_to_peak: bool,
    ignore_leading_seconds: float,
    analysis_duration_seconds: Optional[float] = None,
) -> AlignedSignal:
    """
    The reference's shared time-selection policy: optionally start at the
    absolute peak, skip `ignore_leading_seconds`, optionally keep only
    `analysis_duration_seconds`.
    """
    length = length.to(torch.int32)
    n = x.shape[-1]
    if trim_to_peak:
        start = peak_index(x, length)
    else:
        start = torch.zeros(length.shape, dtype=torch.int32, device=x.device)

    ignore = int(round(float(ignore_leading_seconds) * float(sample_rate_hz)))
    if ignore > 0:
        start = torch.minimum(start + ignore, length)

    aligned = shift_to(x, start, length)

    if analysis_duration_seconds is not None:
        keep = int(round(float(analysis_duration_seconds) * float(sample_rate_hz)))
        keep = max(0, min(keep, n))
        new_length = torch.clamp(aligned.length, max=keep)
        mask = bool_valid_mask(n, new_length)
        aligned = AlignedSignal(
            torch.where(mask, aligned.samples, 0.0), new_length, aligned.start_index
        )
    return aligned
