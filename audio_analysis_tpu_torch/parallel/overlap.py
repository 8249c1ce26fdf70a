"""
Host/device overlap (audio_analysis_tpu/parallel/overlap.py): matplotlib
figures render on one worker thread while the main thread goes on
enqueueing device work, so the device and the rasteriser run at the same
time.

Matplotlib (pyplot + Agg) is not thread-safe across threads, so all figure
work is confined to the one worker thread; the main thread only touches
numpy results. `drain()` re-raises the first worker exception, so failures
keep the per-tap isolation of the bundle runner.
"""

from __future__ import annotations

import functools
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple


# internal drain/idle marker: compared by object identity so no caller label
# (tap names, output paths) can ever collide with it
_IDLE = object()


def _job_kind(job: Callable[[], None]) -> str:
    """Stable name for a render job: the underlying function of a partial
    (the report submits `partial(render_decay_plots, ...)` etc.)."""
    fn = job
    while isinstance(fn, functools.partial):
        fn = fn.func
    return getattr(fn, "__name__", type(fn).__name__)


class KindTimer:
    """Wall seconds + job counts per render-function name. Not locked: each
    worker flavor confines writes to one thread and reads after drain."""

    def __init__(self) -> None:
        self._seconds: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        # the first job per kind pays the figure-template build; recording
        # it separately makes the amortisation visible in plot_timings.json
        self._first: Dict[str, float] = {}
        # CPU seconds spent on the render thread (time.thread_time): the
        # worker shares the GIL (and on a small host the cores) with the
        # main thread's numpy and decode work, so per-kind wall time swings
        # with scheduling, not render cost. cpu_seconds is the stable
        # attribution; wall - cpu is time the thread sat runnable but starved.
        self._cpu: Dict[str, float] = {}

    def add(self, kind: str, seconds: float, cpu_seconds: float = 0.0) -> None:
        self._seconds[kind] = self._seconds.get(kind, 0.0) + seconds
        self._counts[kind] = self._counts.get(kind, 0) + 1
        self._first.setdefault(kind, seconds)
        self._cpu[kind] = self._cpu.get(kind, 0.0) + cpu_seconds

    def as_sorted(self) -> Dict[str, Tuple[float, int, float, float]]:
        return {
            kind: (
                self._seconds[kind],
                self._counts[kind],
                self._first[kind],
                self._cpu[kind],
            )
            for kind in sorted(self._seconds, key=self._seconds.get, reverse=True)
        }


class PlotWorker:
    """
    Single-thread executor for figure rendering jobs (FIFO order).

    The queue is bounded: submitted closures pin their figure inputs
    (images, megapoint curves: tens of MB per tap), so on a long bundle run
    an unbounded backlog would hold GBs of host RAM.
    `submit` blocks once ~a few taps of figures are in flight, which
    preserves the overlap with O(1) memory.
    """

    def __init__(self, max_pending_jobs: int = 32) -> None:
        self._queue: "queue.Queue[Optional[Tuple[Callable[[], None], Optional[str]]]]" = (
            queue.Queue(maxsize=max(2, max_pending_jobs))
        )
        self._errors: List[Tuple[Optional[str], BaseException]] = []
        # per-render-function wall seconds/counts, written only by the worker
        # thread and read after drain — the cheap profile behind
        # reports/plot_timings.json
        self._timer = KindTimer()
        self._thread = threading.Thread(target=self._run, name="plot-worker", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            job, label = item
            if label is _IDLE:
                job()
                continue
            kind = _job_kind(job)
            start = time.perf_counter()
            cpu_start = time.thread_time()
            try:
                job()
            except BaseException as exc:  # noqa: BLE001 — surfaced in drain()
                self._errors.append((label, exc))
            finally:
                self._timer.add(
                    kind,
                    time.perf_counter() - start,
                    time.thread_time() - cpu_start,
                )

    def submit(self, job: Callable[[], None], label: Optional[str] = None) -> None:
        self._queue.put((job, label))

    def _wait_idle(self) -> None:
        done = threading.Event()
        self._queue.put((done.set, _IDLE))
        done.wait()

    def timings_by_kind(self) -> Dict[str, Tuple[float, int, float, float]]:
        """{render_fn_name: (total_seconds, jobs, first_job_seconds,
        cpu_seconds)} — call after drain()."""
        return self._timer.as_sorted()

    def drain(self) -> None:
        """Block until every submitted job ran; re-raise the first failure
        (and clear it, like drain_collect — a handled failure must not be
        re-raised by every later drain)."""
        self._wait_idle()
        if self._errors:
            errors, self._errors = self._errors, []
            raise errors[0][1]

    def drain_collect(self) -> List[Tuple[Optional[str], BaseException]]:
        """Block until idle; return (and clear) labeled failures instead of
        raising — bundle runners keep per-tap failure isolation this way."""
        self._wait_idle()
        errors, self._errors = self._errors, []
        return errors

    def close(self) -> None:
        self._queue.put(None)
        self._thread.join(timeout=60)


def make_plot_worker(overlap_enabled: bool, processes: int = 0):
    """
    The report/bundle plot-worker factory: a spawn-based process pool when
    `processes` > 0 (multi-core hosts; parallel/procpool.py), else the
    single-thread MaybePlotWorker. Both share the submit/drain contract.
    """
    if processes and int(processes) > 0:
        from audio_analysis_tpu_torch.parallel.procpool import ProcessPlotPool

        return ProcessPlotPool(int(processes))
    return MaybePlotWorker(overlap_enabled)


class BorrowedPlotWorker:
    """
    Context-manager view over a caller-owned worker: submits pass through,
    but drain/exit are no-ops — the owner drains once across many reports
    (the bundle runner overlaps tap k's rendering with tap k+1's device
    compute this way).
    """

    def __init__(self, worker: "MaybePlotWorker", default_label: Optional[str] = None) -> None:
        self._worker = worker
        self._default_label = default_label

    def submit(self, job: Callable[[], None], label: Optional[str] = None) -> None:
        self._worker.submit(job, label or self._default_label)

    def drain(self) -> None:  # owner drains
        pass

    def __enter__(self) -> "BorrowedPlotWorker":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


class MaybePlotWorker:
    """
    PlotWorker when overlap is enabled, synchronous execution otherwise:
    one code path and one failure contract for callers. Render errors are
    always deferred to drain()/drain_collect(), never raised from submit(),
    so flipping the overlap knob cannot change what a user sees.
    """

    def __init__(self, enabled: bool) -> None:
        self._worker = PlotWorker() if enabled else None
        self._sync_errors: List[Tuple[Optional[str], BaseException]] = []
        self._sync_timer = KindTimer()

    def submit(self, job: Callable[[], None], label: Optional[str] = None) -> None:
        if self._worker is None:
            kind = _job_kind(job)
            start = time.perf_counter()
            cpu_start = time.thread_time()
            try:
                job()
            except BaseException as exc:  # noqa: BLE001 — surfaced in drain()
                self._sync_errors.append((label, exc))
            finally:
                self._sync_timer.add(
                    kind,
                    time.perf_counter() - start,
                    time.thread_time() - cpu_start,
                )
        else:
            self._worker.submit(job, label)

    def timings_by_kind(self) -> Dict[str, Tuple[float, int, float, float]]:
        if self._worker is not None:
            return self._worker.timings_by_kind()
        return self._sync_timer.as_sorted()

    def drain(self) -> None:
        if self._worker is not None:
            self._worker.drain()
        elif self._sync_errors:
            errors, self._sync_errors = self._sync_errors, []
            raise errors[0][1]

    def drain_collect(self) -> List[Tuple[Optional[str], BaseException]]:
        if self._worker is not None:
            return self._worker.drain_collect()
        errors, self._sync_errors = self._sync_errors, []
        return errors

    def close(self) -> None:
        if self._worker is not None:
            self._worker.close()

    def __enter__(self) -> "MaybePlotWorker":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            if exc_type is None:
                self.drain()
        finally:
            self.close()
