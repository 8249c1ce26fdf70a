"""
Timing and tracing of the report path (audio_analysis_tpu/utils/timing.py):

- BlockTimer: host wall seconds per analysis block, rendered as the
  report's `--timing` footer table;
- profile_trace: torch.profiler around a block for `report --profile-dir`,
  written as a Chrome trace (CPU and, where a card is present, CUDA
  activity) into the directory.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, List, Optional, Tuple


@dataclass
class BlockTimer:
    """Accumulates named block durations in insertion order."""

    blocks: List[Tuple[str, float]] = field(default_factory=list)

    @contextlib.contextmanager
    def block(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self.blocks.append((name, time.perf_counter() - start))

    def total_seconds(self) -> float:
        return sum(t for _, t in self.blocks)

    def as_markdown(self) -> str:
        lines = ["\n## Timing\n", "", "| Block | Seconds |", "|---|---|"]
        for name, seconds in self.blocks:
            lines.append(f"| {name} | {seconds:.3f} |")
        lines.append(f"| **total** | **{self.total_seconds():.3f}** |")
        return "\n".join(lines) + "\n"

    def as_text(self) -> str:
        return "\n".join(f"{name}: {seconds:.3f}s" for name, seconds in self.blocks)


@contextlib.contextmanager
def profile_trace(profile_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler over the block when a directory is given, its Chrome
    trace written to <profile_dir>/trace.json; else a no-op."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
