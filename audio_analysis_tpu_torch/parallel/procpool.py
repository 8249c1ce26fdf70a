"""
Process-parallel figure rendering (audio_analysis_tpu/parallel/procpool.py).

The thread worker (parallel/overlap.py) overlaps rendering with device
work but holds the plot path to about one host core (matplotlib is
confined to one thread). Every render job is a picklable partial of a
top-level `render_*_plots` function over result dataclasses of numpy
arrays and frozen settings, so the same jobs fan out over a spawn-based
process pool on multi-core hosts.

Render children never touch the card: every child is spawned with
CUDA_VISIBLE_DEVICES="" and MPLBACKEND=Agg in its environment, so both
hold before the child imports torch (and in any process it starts). A job
that carried a tensor would fail to pickle or make its child load torch's
device state; the analyses hand numpy only.

Same submit/drain/drain_collect/close contract as MaybePlotWorker: render
errors are deferred to drain()/drain_collect(), never raised from submit().
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
import time
from concurrent.futures import (
    FIRST_COMPLETED,
    BrokenExecutor,
    Future,
    ProcessPoolExecutor,
    wait,
)
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from audio_analysis_tpu_torch.parallel.overlap import KindTimer, _job_kind

# the environment of every render child: no card, the headless raster backend
_CHILD_ENV = {"CUDA_VISIBLE_DEVICES": "", "MPLBACKEND": "Agg"}


@contextlib.contextmanager
def _child_environment() -> Iterator[None]:
    """os.environ with _CHILD_ENV set, restored after: a spawned child
    inherits the environment of the moment it is spawned."""
    saved = {key: os.environ.get(key) for key in _CHILD_ENV}
    os.environ.update(_CHILD_ENV)
    try:
        yield
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def _run_timed(
    job: Callable[[], None],
) -> Tuple[float, float, Optional[BaseException]]:
    """Top-level (picklable) wrapper: run the render job in the child and
    return (wall seconds there, CPU seconds there, error-or-None), so the
    parent's timings_by_kind costs remote renders, failed ones included.
    (If a raised error cannot be pickled, the executor surfaces the
    pickling failure via future.exception() and only that job's timing is
    lost.)"""
    start = time.perf_counter()
    cpu_start = time.thread_time()
    try:
        job()
        err: Optional[BaseException] = None
    except BaseException as exc:  # noqa: BLE001 — reported via drain()
        err = exc
    return time.perf_counter() - start, time.thread_time() - cpu_start, err


class ProcessPlotPool:
    """
    Fan figure-render jobs over `num_workers` spawn processes.

    Pending jobs are bounded like the thread worker's queue: submitted
    closures pin their figure inputs (tens of MB per tap), so `submit`
    blocks once `max_pending_jobs` are in flight.
    """

    # a job whose future comes back BrokenExecutor this many times is
    # recorded as that job's failure instead of retried again (2 tolerates
    # one innocent-casualty race on a dying pool on top of the first hit)
    _MAX_BROKEN_RETRIES = 2

    def __init__(self, num_workers: int, max_pending_jobs: int = 32) -> None:
        self._num_workers = max(1, int(num_workers))
        self._pool = self._new_pool()
        self._max_pending = max(2, max_pending_jobs)
        # (label, kind, job, future, broken_attempts) — reaped eagerly in
        # submit() so completed jobs' closures (which pin figure inputs,
        # tens of MB per tap) are released as the bundle progresses, not
        # held until the final drain
        self._pending: List[Tuple[Optional[str], str, Callable[[], None], Future, int]] = []
        self._errors: List[Tuple[Optional[str], BaseException]] = []
        # per-kind CHILD wall seconds (summed across workers, so totals can
        # exceed parent wall time when renders run concurrently)
        self._timer = KindTimer()

    def _new_pool(self) -> ProcessPoolExecutor:
        return ProcessPoolExecutor(max_workers=self._num_workers, mp_context=mp.get_context("spawn"))

    def submit(self, job: Callable[[], None], label: Optional[str] = None) -> None:
        self._reap(block=False)
        while sum(not f.done() for _, _, _, f, _ in self._pending) >= self._max_pending:
            wait(
                [f for _, _, _, f, _ in self._pending if not f.done()],
                return_when=FIRST_COMPLETED,
            )
            self._reap(block=False)
        try:
            future = self._submit(job)
        except BaseException as exc:  # noqa: BLE001 — pool broken; heal below
            self._retry_broken(label, _job_kind(job), job, 0, exc)
            return
        self._pending.append((label, _job_kind(job), job, future, 0))

    def _submit(self, job: Callable[[], None]) -> Future:
        """Submit one job; the executor spawns a child here when none is
        idle, and the child inherits _CHILD_ENV."""
        with _child_environment():
            return self._pool.submit(_run_timed, job)

    def _run_inline(self, job: Callable[[], None], label: Optional[str]) -> None:
        """Last resort: render in THIS process, used only when a fresh pool
        cannot even be spawned (an environment failure, not the job's
        fault) — the figures must still be written, just without
        parallelism. Safe: matplotlib is only ever touched from the
        caller's thread on this path (the pool has no render thread)."""
        seconds, cpu_seconds, err = _run_timed(job)
        self._timer.add(_job_kind(job), seconds, cpu_seconds)
        if err is not None:
            self._errors.append((label, err))

    def _rebuild_pool(self) -> bool:
        """Replace a broken executor with a fresh one; False if spawning
        itself fails."""
        try:
            self._pool.shutdown(wait=False, cancel_futures=True)
        except BaseException:  # noqa: BLE001 — already-broken pool
            pass
        try:
            self._pool = self._new_pool()
            return True
        except BaseException:  # noqa: BLE001
            return False

    def _retry_broken(
        self,
        label: Optional[str],
        kind: str,
        job: Callable[[], None],
        attempts: int,
        exc: BaseException,
    ) -> None:
        """A broken pool fails EVERY pending future, including the job that
        was executing when the worker died (e.g. the OOM killer took it).
        Innocent casualties are resubmitted to a healed pool and run to
        completion one at a time, so a genuine pool-killer can only take a
        fresh worker down alone; a job that keeps breaking the pool is
        recorded as that job's failure rather than re-run inline in the
        parent, which holds the device context and every pinned figure
        input and must survive the bundle."""
        if attempts >= self._MAX_BROKEN_RETRIES:
            err: BaseException = RuntimeError(
                f"render job {label!r} repeatedly broke the process pool "
                "(worker killed, e.g. by the OOM killer); recorded as a "
                "failure instead of retried in the parent process"
            )
            err.__cause__ = exc
            self._errors.append((label, err))
            return
        for _ in range(2):
            try:
                future = self._submit(job)
            except BaseException:  # noqa: BLE001 — pool (still) broken
                if not self._rebuild_pool():
                    self._run_inline(job, label)
                    return
                continue
            # sequential on purpose: wait this one out before touching the
            # pool again, isolating repeat offenders to their own worker
            self._finish(label, kind, job, future, attempts + 1)
            return
        # two submit attempts failed even after a rebuild
        self._run_inline(job, label)

    def _finish(
        self,
        label: Optional[str],
        kind: str,
        job: Callable[[], None],
        future: Future,
        attempts: int,
    ) -> None:
        exc = future.exception()  # waits for completion; pool-level only
        if exc is not None:
            if isinstance(exc, BrokenExecutor):
                self._retry_broken(label, kind, job, attempts, exc)
            else:
                self._errors.append((label, exc))
            return
        seconds, cpu_seconds, err = future.result()
        self._timer.add(kind, seconds, cpu_seconds)
        if err is not None:
            self._errors.append((label, err))

    def _reap(self, block: bool) -> None:
        """Process finished futures (all of them when `block`), releasing
        their job closures; broken-pool casualties are healed in-place."""
        pending, self._pending = self._pending, []
        for item in pending:
            label, kind, job, future, attempts = item
            if not block and not future.done():
                self._pending.append(item)
                continue
            self._finish(label, kind, job, future, attempts)

    def _collect(self) -> None:
        while self._pending:
            self._reap(block=True)

    def timings_by_kind(self) -> Dict[str, Tuple[float, int, float, float]]:
        """{render_fn_name: (total_child_seconds, jobs, first_job_seconds,
        child_cpu_seconds)} — call after drain()."""
        return self._timer.as_sorted()

    def drain(self) -> None:
        """Block until every submitted job ran; re-raise the first failure
        (and clear it, matching drain_collect's contract)."""
        self._collect()
        if self._errors:
            errors, self._errors = self._errors, []
            raise errors[0][1]

    def drain_collect(self) -> List[Tuple[Optional[str], BaseException]]:
        """Block until idle; return (and clear) labeled failures instead of
        raising — bundle runners keep per-tap failure isolation this way."""
        self._collect()
        errors, self._errors = self._errors, []
        return errors

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self) -> "ProcessPlotPool":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            if exc_type is None:
                self.drain()
        finally:
            self.close()
