"""
Block markers of the engine step (csrc/marker.cu): `mark(block, device)`
launches the block's empty one-thread kernel, `aa_mark_<block>`, on the
device's current stream. `analyze_batch` marks the split of an
interleaved chunk into channel planes where it has one, the step's top and
the start of each block it runs, and its end; a block that its toggle turns
off marks nothing. In a device trace each block's device time is then the
work from its marker to the next one on the step's stream. The step's CUDA
graph captures the markers, so every replay shows them; nothing is read
back. On any other device a marker is a no-op.
"""

from __future__ import annotations

import torch

from audio_analysis_tpu_torch import _build

# in the step's order; the index is the C entry's `block`
BLOCKS = ("deinterleave", "align_decay", "bands", "fr_gd", "stft", "modal", "diffusion", "end")


def mark(block: str, device: torch.device) -> None:
    """Launch the marker of `block` on `device`'s current stream (a CUDA
    device; elsewhere nothing)."""
    index = BLOCKS.index(block)
    if device.type != "cuda":
        return
    lib = _build.library()
    with torch.cuda.device(device):
        code = lib.aa_mark(index, torch.cuda.current_stream(device).cuda_stream)
    _build.check(code, f"marker {block}")
