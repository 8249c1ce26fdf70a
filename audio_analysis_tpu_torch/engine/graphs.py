"""
The engine step as a compiled program. In the JAX package `analyze_batch`
and `analyze_batch_flat` are `jax.jit` programs
(audio_analysis_tpu/engine/batch.py:237 and :570): a chunk is one dispatch
of an executable compiled once per argument shape, dtype and static
config. Here, on a CUDA device, `analyze_batch_flat` replays one CUDA graph
per (device, samples shape and dtype, lengths shape and dtype, step,
EngineConfig) key, the key under which `jax.jit` compiles a new program
(the step: the planar one, or the one that splits an interleaved chunk).

- When to capture. A capture costs more host time than one eager chunk
  and pays back only over the replays after it (PERF.md §5 measures both),
  so a key is captured only where replays are in sight: when the caller
  says at least `MIN_CALLS_AHEAD` more calls of the key follow this one
  (`calls_ahead`: the rest of a bundle's chunks, or of a mesh's shards),
  or when the key already ended an earlier call in this process (a second
  bundle, batch or watch cycle of the same shape). A one-shot bundle of a
  few chunks in a fresh process therefore runs eagerly, as it did before
  graphs.
- The call that captures runs its chunk eagerly first, and that result is
  the chunk's result. So every lazy upload has happened before the
  capture: the engine's device tables, the STFT window and twiddles, the
  selection fractions, the cuFFT plans. Values of those caches
  (`ops.common.device_cache`) that the capture reads are held by the
  graph, so an eviction there cannot free memory the graph reads. The
  capture stream's cuBLAS workspace is made by one small matmul outside
  the capture, so it does not land in the graph's pool.
- cuFFT plans are not held that way: torch's per-device plan cache owns
  them, and a replay reads the plan's memory. A graph therefore relies on
  that cache never evicting or destroying a plan it captured. A capture
  raises when the cache is full (an insertion would evict), and a replay
  raises when the cache has since filled up or shrunk (cleared, or its
  max_size lowered). Clearing it under live graphs is the caller's fault:
  leave graphs first (`eager()` clears them).
- The next chunk of the key copies its samples and lengths into the
  graph's static inputs on the current (compute) stream, replays the
  graph on that stream and clones the flat output: the caller holds every
  chunk's vector until one packed fetch, and the next replay overwrites
  the static output. Replays on one device are ordered one after another
  (a replay on another stream than the last waits for it). Two mesh
  shards on one card share one graph.
- Capture mode: thread-local. The bundle pipeline's prefetch worker pins
  host memory and copies on a side stream while the main thread computes;
  in the global mode those calls (host allocations, the host allocator's
  event queries) would be refused or would invalidate the capture.
  Thread-local mode refuses unsafe calls on the capturing thread only, the
  step itself, which makes none (tests/test_torch_engine_graph.py: no host
  data in and no read back in a warm step). The worker's copies run on
  their own streams, never on the capture stream.
- Launch counts stay what an eager run counts. The kernel wrappers
  (ops/edc.py, ops/stft.py) count their launches while the capture
  records them, although nothing ran; the cache takes that back and adds
  it again on every replay.
- Memory: at most MAX_GRAPHS graphs (the size of the engine's table
  cache), the least recently used evicted first. The graphs of one device
  share one memory pool: replays never overlap, so one graph's
  intermediates may live where another's were, and each graph's static
  output stays allocated while the graph lives and is cloned right after
  its replay. The pool is therefore about one step's working set plus the
  live graphs' outputs, not one working set a graph. An evicted graph's
  blocks go back to the pool for the next capture; when a device's last
  graph goes, its pool goes with it (the allocator frees a pool no graph
  uses, as its other cached blocks, at the next `torch.cuda.empty_cache`
  or when an allocation outside a capture runs short). The allocator
  cannot free cached memory while a capture is underway, so where the
  device has less memory free than the allocator holds idle (the key's
  eager chunk has just freed its working set into that cache) the cache
  is returned to the device before the capture, a synchronising call
  counted in `memory_returns`.
- No fallback: a failed capture or replay raises, and nothing is cached
  for a failed capture. `eager()` runs the step eagerly on the card, the
  counterpart of `jax.disable_jit()`, and clears the cache on entry. On
  the CPU the step always runs eagerly.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

from audio_analysis_tpu_torch import _build
from audio_analysis_tpu_torch.ops.common import holding
from audio_analysis_tpu_torch.utils.timing import span

MAX_GRAPHS = 4
# the replays over which a capture pays for itself in one call: on the
# H100 3-5 in a warm process, more in a fresh one, where a capture takes
# longer (capture host ms over the wall a replayed chunk saves; PERF.md §5)
MIN_CALLS_AHEAD = 6
# keys remembered as having ended a call (a capture's second trigger)
SEEN_KEYS = 64

_eager_lock = threading.Lock()
_eager_depth = 0


@dataclass
class _Entry:
    graph: object  # torch.cuda.CUDAGraph (or a stand-in with replay() and reset())
    samples: torch.Tensor  # static inputs the graph reads
    lengths: torch.Tensor
    output: torch.Tensor  # static flat output the graph writes
    spec: list
    launches: List[Tuple[_build.LaunchCounter, int]]  # what one replay launches
    capture_ms: float
    held: list = field(default_factory=list)  # device constants the graph reads
    plans: int = 0  # the device's cuFFT plan cache size after the capture


def _warm_blas(device: torch.device) -> None:
    """Create the current stream's cuBLAS handle and workspace."""
    a = torch.ones((8, 8), device=device)
    torch.matmul(a, a)


def _plan_cache(device: torch.device):
    return torch.backends.cuda.cufft_plan_cache[device.index if device.index is not None else 0]


_capture_streams: Dict[torch.device, torch.cuda.Stream] = {}


def capture_cuda(fn: Callable, device: torch.device, pool=None):
    """(graph, fn()): fn captured into a CUDA graph on the device's capture
    stream, thread-local mode, its memory from `pool` (a
    torch.cuda.graph_pool_handle shared with the device's other graphs).
    Nothing runs. A capture that fails raises the step's own error; its
    capture is ended and dropped."""
    stream = _capture_streams.get(device)
    if stream is None:
        stream = _capture_streams[device] = torch.cuda.Stream(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), torch.cuda.stream(stream):
        _warm_blas(device)
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            result = fn()
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass  # the capture the step's error invalidated
            raise
        graph.capture_end()
    return graph, result


class StepGraphs:
    """The cache of captured steps: `run(step, samples, lengths, config,
    calls_ahead)` runs `step` eagerly for a key without a graph, captures
    it after where replays are in sight, and replays the key's graph on
    every later call. `capture(fn, device, pool)` returns (graph, fn())
    without running fn on the device (tests pass a stand-in)."""

    def __init__(self, capacity: int = MAX_GRAPHS, capture: Callable = capture_cuda,
                 min_calls_ahead: int = MIN_CALLS_AHEAD) -> None:
        self.capacity = capacity
        self.min_calls_ahead = min_calls_ahead
        self._capture = capture
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._seen: "OrderedDict[tuple, None]" = OrderedDict()
        self._pools: Dict[torch.device, object] = {}
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._lock = threading.Lock()
        self.captures = self.replays = self.evictions = self.memory_returns = 0

    @staticmethod
    def key(step: Callable, samples: torch.Tensor, lengths: torch.Tensor, config) -> tuple:
        return (samples.device, tuple(samples.shape), samples.dtype, tuple(lengths.shape), lengths.dtype, step, config)

    def run(self, step: Callable, samples: torch.Tensor, lengths: torch.Tensor, config, calls_ahead: int = 0):
        """step(samples, lengths, config), through the key's graph where
        there is one. `calls_ahead`: how many more calls of this key the
        caller makes right after this one."""
        key = self.key(step, samples, lengths, config)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                result = step(samples, lengths, config)
                if calls_ahead >= self.min_calls_ahead or key in self._seen:
                    with span("aa.graphs.capture"):
                        self._add(key, step, samples, lengths, config)
                if calls_ahead == 0:
                    self._seen[key] = None
                    self._seen.move_to_end(key)
                    while len(self._seen) > SEEN_KEYS:
                        self._seen.popitem(last=False)
                return result
            self._entries.move_to_end(key)
            with span("aa.graphs.replay"):
                if samples.device.type == "cuda":
                    plans = _plan_cache(samples.device)
                    if plans.size < entry.plans or plans.size >= plans.max_size:
                        raise RuntimeError(
                            f"the cuFFT plan cache went from {entry.plans} plans to {plans.size} of "
                            f"{plans.max_size} since this graph was captured: a plan the graph reads may have been "
                            "freed; clear the graphs (engine.eager()) before clearing, shrinking or filling that "
                            "cache")
                    stream = torch.cuda.current_stream(samples.device)
                    last = self._streams.get(samples.device)
                    if last is not None and last != stream:
                        stream.wait_stream(last)
                    self._streams[samples.device] = stream
                entry.samples.copy_(samples)
                entry.lengths.copy_(lengths)
                entry.graph.replay()
                for counter, n in entry.launches:
                    counter.launches += n
                self.replays += 1
                return entry.output.clone(), entry.spec

    def _add(self, key: tuple, step: Callable, samples, lengths, config) -> None:
        while len(self._entries) >= self.capacity:
            self._release(self._entries.popitem(last=False)[1])
        device = samples.device
        pool = None
        if device.type == "cuda":
            plans = _plan_cache(device)
            if plans.size >= plans.max_size:
                raise RuntimeError(
                    f"the cuFFT plan cache is full ({plans.size} of {plans.max_size} plans): a plan this graph "
                    "captured could be evicted and freed under it; raise "
                    "torch.backends.cuda.cufft_plan_cache.max_size")
            free, _total = torch.cuda.mem_get_info(device)
            if free < torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device):
                torch.cuda.empty_cache()
                self.memory_returns += 1
            pool = self._pools.get(device)
            if pool is None:
                pool = self._pools[device] = torch.cuda.graph_pool_handle()
        static_samples = samples.clone(memory_format=torch.contiguous_format)
        static_lengths = lengths.clone(memory_format=torch.contiguous_format)
        counters = _build.launch_counters()
        before = [c.launches for c in counters]
        held: list = []
        t0 = time.perf_counter()
        try:
            with holding(held):
                graph, (output, spec) = self._capture(
                    lambda: step(static_samples, static_lengths, config), device, pool
                )
        except BaseException:
            self._drop_pool(device)
            raise
        finally:
            launches = [(c, c.launches - b) for c, b in zip(counters, before) if c.launches != b]
            for c, b in zip(counters, before):
                c.launches = b
        capture_ms = (time.perf_counter() - t0) * 1e3
        plans = _plan_cache(device).size if device.type == "cuda" else 0
        self._entries[key] = _Entry(graph, static_samples, static_lengths, output, spec, launches, capture_ms, held,
                                    plans)
        self.captures += 1

    def _release(self, entry: _Entry) -> None:
        entry.graph.reset()
        self.evictions += 1
        self._drop_pool(entry.samples.device)

    def _drop_pool(self, device: torch.device) -> None:
        """Forget the device's pool once no graph of it is left: a pool
        whose last graph is gone cannot be shared again, the next capture
        starts a new one."""
        if not any(k[0] == device for k in self._entries):
            self._pools.pop(device, None)
            self._streams.pop(device, None)

    def clear(self) -> None:
        """Release every graph (the keys seen stay remembered)."""
        with self._lock:
            while self._entries:
                self._release(self._entries.popitem(last=False)[1])

    def pool(self, device: torch.device):
        """The memory pool handle the device's live graphs share (None
        without a graph)."""
        with self._lock:
            return self._pools.get(device)

    def keys(self) -> list:
        """The cached keys, least recently used first."""
        with self._lock:
            return list(self._entries)

    def capture_ms(self, key: tuple) -> float:
        """Host milliseconds of the key's capture and instantiation (the
        static inputs' copies and the memory returned before it excluded)."""
        return self._entries[key].capture_ms

    def stats(self) -> dict:
        return {"graphs": len(self._entries), "captures": self.captures, "replays": self.replays,
                "evictions": self.evictions, "memory_returns": self.memory_returns}


# the process's cache, as jax.jit's is the process's
STEP_GRAPHS = StepGraphs()


@contextlib.contextmanager
def eager():
    """Run the engine step eagerly on the card inside the block (the
    counterpart of `jax.disable_jit()`), in every thread; the graph cache
    is cleared on entry."""
    global _eager_depth
    with _eager_lock:
        _eager_depth += 1
    try:
        STEP_GRAPHS.clear()
        yield
    finally:
        with _eager_lock:
            _eager_depth -= 1


def enabled(device: torch.device) -> bool:
    """Whether the step on `device` goes through a graph: a CUDA device
    outside `eager()`."""
    return device.type == "cuda" and _eager_depth == 0
