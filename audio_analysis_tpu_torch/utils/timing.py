"""
Timing and tracing (audio_analysis_tpu/utils/timing.py):

- BlockTimer: host wall seconds per analysis block, rendered as the
  report's `--timing` footer table;
- span: a named host span of the program. Inside a torch.profiler session
  it is a `record_function` range, so the trace names the stretch of host
  time (and the device work it enqueues); outside one it costs a flag
  read. Given a `phases` dict and a key it also adds its wall seconds to
  that key, in or out of a session;
- profile_trace: torch.profiler around a block for `report --profile-dir`,
  written as a Chrome trace (CPU and, where a card is present, CUDA
  activity, of every thread) into the directory.

The spans of a bundle call (report/engine_report.py, engine/batch.py,
engine/graphs.py), all named `aa.*`:

    aa.bundle                    run_bundle_report_engine, the whole call
      aa.bundle.probe            headers and lengths (phases probe_s)
      aa.bundle.prepare          reports dir, mesh, device audio cache lookup
      aa.pipeline.prefetch       handing the next chunk to the prefetch worker
      aa.pipeline.decode_wait    waiting on the prefetch worker (decode_wait_s)
      aa.pipeline.dispatch       enqueueing a chunk's step (h2d_dispatch_s)
        aa.graphs.replay | aa.graphs.capture
      aa.pipeline.fetch          a chunk's device->host copy (fetch_s)
        aa.pipeline.unpack
      aa.pipeline.callback       the per-chunk callback (markdown_s)
        aa.report.markdown       the chunk's per-tap summaries
        aa.report.json_encode    the chunk's rows of bundle_metrics.json
      aa.pipeline.gather         executor shutdown, the final concatenation
      aa.report.tail             from the last chunk's fetch to the return:
                                 its callback, json_build, write (a bundle
                                 of C > 2 channels: tail_s, up to write)
      aa.report.json_build       the file's head, the compare (json_s)
      aa.report.write            joining the encoded rows, bundle_metrics.json,
                                 the index, freeing the rows

    on the prefetch worker's thread, for a bundle of C > 2 channels:
      aa.io.read_interleaved     a chunk's taps read into its page-locked
                                 buffer (read_s, summed over the chunks)

(On the float32 path, which decodes the whole bundle up front, the
summaries and the encoding are one `aa.report.markdown` after the pipeline,
inside `aa.report.tail`.) The engine step's own markers are ops/marker.py's.
A bundle of C > 2 channels also counts `frame_groups` in its phases: the
frame-block tap groups its steps ran (engine.batch.frame_tap_groups).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler


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


def profiling() -> bool:
    """Whether a torch.profiler session is active in the process. torch
    sets this flag on every session's start and clears it on its stop;
    `torch._C._autograd._profiler_enabled()` is thread-local and reads
    False on every thread of a session built with `profile_all_threads`."""
    return _autograd_profiler._is_profiler_enabled


class span:
    """`with span(name, phases, key):` a named host span; see the
    module docstring. The duration added to `phases[key]` is the
    perf_counter difference around the block, as a hand-written pair of
    perf_counter calls would give it, unrounded."""

    __slots__ = ("name", "phases", "key", "_t0", "_range")

    def __init__(self, name: str, phases: Optional[Dict[str, float]] = None, key: Optional[str] = None) -> None:
        self.name, self.phases, self.key = name, phases, key
        self._range = None

    def __enter__(self) -> "span":
        if profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.phases is not None:
            self.phases[self.key] = self.phases.get(self.key, 0.0) + (time.perf_counter() - self._t0)
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None


@contextlib.contextmanager
def profile_trace(profile_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler over the block when a directory is given, its Chrome
    trace written to <profile_dir>/trace.json; else a no-op. Every thread
    is recorded: the report's figure thread as well as the main thread."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    all_threads = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=activities, experimental_config=all_threads) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
