"""The engine step as a compiled program (audio_analysis_tpu_torch.engine.graphs)
on the CPU, where no CUDA graph can be captured:

(a) a warm `analyze_batch` creates no tensor from host data and reads none
    back (torch.tensor, torch.from_numpy, torch.as_tensor and Tensor.item,
    .cpu, .tolist, .numpy raise inside the step after one warm-up call),
    over the configs whose step differs: three bands, octave, third,
    --bands-decimate and modal_trim_bins, float32 and int16 input. A step
    that passes can be captured: on the card such a call is refused or
    breaks the capture;
(b) the graph cache's keying, its least-recently-used eviction at
    MAX_GRAPHS, its clone of the flat output and its launch accounting,
    with a stand-in graph whose replay runs the step again into the static
    output (as a CUDA graph rewrites the memory it captured), and the
    pipelined bundle and a CPU mesh through stand-in graphs: bit-equal to
    the eager run, and within the stated limits of the JAX engine; when
    the cache captures: with MIN_CALLS_AHEAD calls of the key in sight
    (the pipeline and the mesh count them), or for a key that ended an
    earlier call, never otherwise;
(c) on the CPU the engine never captures, and `eager()` is a no-op there
    (it clears the cache on entry and turns graphs off in its block).

Tolerances against the JAX engine: integers and flags exact, group delay
1e-3 relative (the noise taps' float32 phase), other floats 1e-4 relative
and absolute (phase 5's JSON limits; tests/test_torch_engine.py holds the
eager step to tighter per-key limits).
"""

import dataclasses
from unittest import mock

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from audio_analysis_tpu.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from audio_analysis_tpu.engine import analyze_batch as jax_analyze_batch  # noqa: E402
from audio_analysis_tpu_torch import _build  # noqa: E402
from audio_analysis_tpu_torch.engine import (  # noqa: E402
    EngineConfig,
    analyze_batch,
    analyze_batch_flat,
    analyze_bundle_pipelined,
    config_from_jax,
    eager,
    make_mesh,
)
from audio_analysis_tpu_torch.engine import batch as batch_module  # noqa: E402
from audio_analysis_tpu_torch.engine import graphs  # noqa: E402
from audio_analysis_tpu_torch.ops import selectq  # noqa: E402

torch.set_num_threads(2)

SR = 48_000
N = 1 << 16  # --bands-decimate needs N / 2 >= 16384 for a factor above 1


def _taps(taps: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = np.zeros((taps, 2, n), np.float32)
    x[:, :, 64:] = 0.05 * rng.standard_normal((taps, 2, n - 64)) * 10.0 ** (-3.0 * t[: n - 64] / 0.4)
    x[:, :, 64] = 0.9
    lengths = (n - 700 * np.arange(taps)).astype(np.int32)
    for i, length in enumerate(lengths):
        x[i, :, length:] = 0.0
    return x, lengths


# ------------------------------------------- (a) no host data in the step ----

STEP_CASES = {
    "three": ({}, np.float32),
    "three_int16": ({}, np.int16),
    "octave": ({"band_mode": "octave"}, np.float32),
    "third": ({"band_mode": "third"}, np.float32),
    "bands_decimate": ({"bands_decimate": True}, np.int16),
    "third_decimate": ({"band_mode": "third", "bands_decimate": True}, np.float32),
    "modal_trim_bins": ({"modal_trim_bins": True}, np.int16),
}


def _refuse(name):
    def refuse(*_args, **_kwargs):
        raise AssertionError(f"the engine step called {name}")

    return refuse


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_warm_step_moves_no_host_data(case):
    fields, dtype = STEP_CASES[case]
    cfg = dataclasses.replace(EngineConfig(), **fields)
    x, lengths = _taps(2, N, 5)
    if dtype == np.int16:
        x = np.clip(np.round(x * 32767.0), -32768, 32767).astype(np.int16)
    xs, ls = torch.from_numpy(x), torch.from_numpy(lengths)
    warm = analyze_batch(xs, ls, cfg)
    patches = [mock.patch.object(torch, name, _refuse(f"torch.{name}")) for name in ("tensor", "from_numpy", "as_tensor")]
    patches += [mock.patch.object(torch.Tensor, name, _refuse(f"Tensor.{name}")) for name in ("item", "cpu", "tolist", "numpy")]
    for p in patches:
        p.start()
    try:
        again = analyze_batch(xs, ls, cfg)
    finally:
        for p in patches:
            p.stop()
    assert sorted(again) == sorted(warm)
    for key, value in warm.items():
        torch.testing.assert_close(again[key], value, rtol=0, atol=0, equal_nan=True)


# ------------------------------------------------ (b) the cache's bookkeeping ----

TOY = _build.LaunchCounter("toy_kernel")
TOY_LAUNCHES = 2


def _toy_step(samples, lengths, scale):
    """A step whose wrapper counts TOY_LAUNCHES launches: the samples times
    `scale` (the config), and the lengths, in one flat vector."""
    TOY.launches += TOY_LAUNCHES
    flat = torch.cat([samples.to(torch.float32).reshape(-1) * scale, lengths.to(torch.float32)])
    return flat, [("toy", tuple(flat.shape), np.float32)]


class StandInGraph:
    """A CUDA graph's stand-in: replay runs the captured step again and
    writes its flat vector into the static output the capture returned,
    leaving every launch counter as it was (a replay runs no wrapper)."""

    def __init__(self, fn, output):
        self.fn, self.output = fn, output
        self.replays = self.resets = 0

    def replay(self):
        counters = _build.launch_counters()
        before = [c.launches for c in counters]
        flat, _spec = self.fn()
        for c, b in zip(counters, before):
            c.launches = b
        self.output.copy_(flat)
        self.replays += 1

    def reset(self):
        self.resets += 1


def stand_in_capture(fn, _device, _pool=None):
    flat, spec = fn()
    return StandInGraph(fn, flat), (flat, spec)


def _chunk(shape, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    samples = (torch.rand(shape, generator=g) * 100).to(dtype)
    lengths = torch.randint(0, 1000, shape[:1], generator=g, dtype=torch.int32)
    return samples, lengths


def test_cache_keys_on_shape_dtype_lengths_and_config():
    cache = graphs.StepGraphs(capacity=16, capture=stand_in_capture, min_calls_ahead=0)
    runs = [
        ((2, 3), 0, torch.float32, 1.0),
        ((2, 3), 1, torch.float32, 1.0),  # same key: replay
        ((2, 4), 2, torch.float32, 1.0),  # samples shape
        ((2, 3), 3, torch.int16, 1.0),  # samples dtype
        ((2, 3), 4, torch.float32, 2.0),  # config
        ((2, 4), 5, torch.float32, 1.0),  # replay
    ]
    for shape, seed, dtype, scale in runs:
        s, ls = _chunk(shape, seed, dtype)
        cache.run(_toy_step, s, ls, scale)
    s, ls = _chunk((2, 3), 6)
    cache.run(_toy_step, s, torch.cat([ls, ls]), 1.0)  # lengths shape
    assert cache.stats() == {"graphs": 5, "captures": 5, "replays": 2, "evictions": 0, "memory_returns": 0}
    assert cache.keys()[-1] == cache.key(_toy_step, s, torch.cat([ls, ls]), 1.0)
    assert {k[1:3] for k in cache.keys()} == {((2, 3), torch.float32), ((2, 4), torch.float32), ((2, 3), torch.int16)}


def test_cache_evicts_the_least_recently_used_at_capacity():
    assert graphs.MAX_GRAPHS == 4
    cache = graphs.StepGraphs(capture=stand_in_capture, min_calls_ahead=0)
    chunks = [_chunk((1, 2 + i), i) for i in range(5)]
    for s, ls in chunks[:4]:
        cache.run(_toy_step, s, ls, 1.0)
    evicted = cache._entries[cache.key(_toy_step, *chunks[1], 1.0)].graph
    cache.run(_toy_step, *chunks[0], 1.0)  # a replay makes key 0 the most recent
    cache.run(_toy_step, *chunks[4], 1.0)
    assert cache.keys() == [cache.key(_toy_step, *chunks[i], 1.0) for i in (2, 3, 0, 4)]
    assert evicted.resets == 1 and cache.stats()["evictions"] == 1
    before = TOY.launches
    flat, _spec = cache.run(_toy_step, *chunks[1], 1.0)  # captured again: its first call is eager
    assert TOY.launches - before == TOY_LAUNCHES
    torch.testing.assert_close(flat, _toy_step(*chunks[1], 1.0)[0], rtol=0, atol=0)
    assert cache.keys()[0] == cache.key(_toy_step, *chunks[3], 1.0)
    cache.clear()
    assert cache.keys() == [] and cache.stats()["evictions"] == 6


def test_replays_return_clones_equal_to_the_eager_step():
    cache = graphs.StepGraphs(capture=stand_in_capture, min_calls_ahead=0)
    chunks = [_chunk((3, 5), seed) for seed in range(4)]
    flats = [cache.run(_toy_step, s, ls, 0.5)[0] for s, ls in chunks]
    assert cache.stats()["replays"] == 3
    (entry,) = cache._entries.values()
    assert all(f.data_ptr() != entry.output.data_ptr() for f in flats)
    for flat, (s, ls) in zip(flats, chunks):  # no replay overwrote an earlier chunk's vector
        torch.testing.assert_close(flat, _toy_step(s, ls, 0.5)[0], rtol=0, atol=0)


def test_capture_adds_no_launches_and_each_replay_adds_the_captured_amount():
    cache = graphs.StepGraphs(capture=stand_in_capture, min_calls_ahead=0)
    TOY.launches = 0
    cache.run(_toy_step, *_chunk((2, 2), 0), 1.0)
    assert TOY.launches == TOY_LAUNCHES  # the eager chunk; the capture took its count back
    (entry,) = cache._entries.values()
    assert entry.launches == [(TOY, TOY_LAUNCHES)]
    for replays in (1, 2, 3):
        cache.run(_toy_step, *_chunk((2, 2), replays), 1.0)
        assert TOY.launches == TOY_LAUNCHES * (1 + replays)
    assert entry.graph.replays == 3


def test_a_failed_capture_raises_and_caches_nothing():
    def failing_capture(fn, _device, _pool=None):
        fn()
        raise RuntimeError("operation not permitted when stream is capturing")

    cache = graphs.StepGraphs(capture=failing_capture, min_calls_ahead=0)
    TOY.launches = 0
    with pytest.raises(RuntimeError, match="capturing"):
        cache.run(_toy_step, *_chunk((2, 2), 0), 1.0)
    assert cache.keys() == [] and TOY.launches == TOY_LAUNCHES
    with pytest.raises(RuntimeError, match="capturing"):  # no quiet eager retry
        cache.run(_toy_step, *_chunk((2, 2), 1), 1.0)


def _captures_and_replays(cache, calls):
    """(captures, replays) over `calls`, each a (chunk seed, calls_ahead)
    of one key."""
    before = cache.stats()
    for seed, ahead in calls:
        cache.run(_toy_step, *_chunk((2, 3), seed), 1.0, ahead)
    after = cache.stats()
    return after["captures"] - before["captures"], after["replays"] - before["replays"]


def test_a_key_is_captured_only_with_replays_in_sight():
    assert graphs.MIN_CALLS_AHEAD == 6
    cache = graphs.StepGraphs(capture=stand_in_capture)
    # a call of two chunks in a fresh process: both eager
    assert _captures_and_replays(cache, [(0, 1), (1, 0)]) == (0, 0)
    # the key ended that call: the next call captures after its first chunk
    assert _captures_and_replays(cache, [(2, 1), (3, 0)]) == (1, 1)
    assert _captures_and_replays(cache, [(4, 1), (5, 0)]) == (0, 2)
    # a key of a fresh cache: captured at once with MIN_CALLS_AHEAD calls to come
    for ahead, expected in ((5, (0, 5)), (6, (1, 6))):
        fresh = graphs.StepGraphs(capture=stand_in_capture)
        calls = [(seed, ahead - seed) for seed in range(ahead + 1)]
        assert _captures_and_replays(fresh, calls[:1]) == (expected[0], 0)
        assert _captures_and_replays(fresh, calls[1:]) == (0, expected[1] if expected[0] else 0)
    # a key whose calls never ended (calls_ahead never 0) is not remembered
    fresh = graphs.StepGraphs(capture=stand_in_capture)
    assert _captures_and_replays(fresh, [(0, 3), (1, 2)]) == (0, 0)
    assert _captures_and_replays(fresh, [(2, 1)]) == (0, 0)


def test_the_keys_seen_are_bounded_and_survive_clear():
    cache = graphs.StepGraphs(capture=stand_in_capture)
    chunks = [_chunk((1, 2 + i), i) for i in range(graphs.SEEN_KEYS + 1)]
    for s, ls in chunks:
        cache.run(_toy_step, s, ls, 1.0)
    assert cache.stats()["captures"] == 0
    cache.run(_toy_step, *chunks[0], 1.0)  # forgotten: the oldest of SEEN_KEYS + 1
    cache.run(_toy_step, *chunks[-1], 1.0)  # remembered: captured
    assert cache.stats()["captures"] == 1
    cache.clear()  # eager() clears the graphs, not what was seen
    cache.run(_toy_step, *chunks[-1], 1.0)
    assert cache.stats()["captures"] == 2


@pytest.mark.parametrize("min_calls_ahead, first_call", [(2, (1, 2)), (3, (0, 0))])
def test_the_pipeline_and_the_mesh_count_the_calls_ahead(monkeypatch, min_calls_ahead, first_call):
    """5 taps in chunks of 2: 3 chunks, so the first has 2 calls ahead; on a
    mesh of two CPU shards, 2 chunks of 2 shards, so the first shard has 3
    of its key ahead. A first call below the threshold runs eagerly; the
    next call of the key captures after its first chunk."""
    cache = graphs.StepGraphs(capture=stand_in_capture, min_calls_ahead=min_calls_ahead)
    monkeypatch.setattr(graphs, "STEP_GRAPHS", cache)
    monkeypatch.setattr(graphs, "enabled", lambda device: graphs._eager_depth == 0)
    x, lengths = _taps(5, SMALL_N, 12)
    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype(np.int16)
    run = dict(config=SMALL_CFG, chunk_taps=2, device="cpu")

    def ran(**kwargs):
        before = cache.stats()
        analyze_bundle_pipelined(lambda lo, hi: pcm[lo:hi], lengths, SMALL_N, **run, **kwargs)
        return cache.stats()["captures"] - before["captures"], cache.stats()["replays"] - before["replays"]

    assert ran() == first_call
    assert ran() == ((0, 3) if first_call[0] else (1, 2))
    cache.clear()
    mesh = make_mesh(2, platform="cpu")
    fresh = graphs.StepGraphs(capture=stand_in_capture, min_calls_ahead=min_calls_ahead + 1)
    monkeypatch.setattr(graphs, "STEP_GRAPHS", fresh)
    cache = fresh
    assert ran(mesh=mesh) == ((1, 3) if first_call[0] else (0, 0))


SMALL_N = 1 << 14
SMALL_CFG = dataclasses.replace(EngineConfig(), run_modal=False)


@pytest.fixture
def stand_in_engine(monkeypatch):
    """The engine step of this process through stand-in graphs, as on the
    card, every key captured after its first chunk."""
    cache = graphs.StepGraphs(capture=stand_in_capture, min_calls_ahead=0)
    monkeypatch.setattr(graphs, "STEP_GRAPHS", cache)
    monkeypatch.setattr(graphs, "enabled", lambda device: graphs._eager_depth == 0)
    return cache


def test_pipelined_bundle_and_mesh_through_graphs_equal_eager_and_jax(stand_in_engine):
    """5 taps in chunks of 2 (the padded last chunk keeps the key): the
    first chunk eager, the next two replays; a mesh of two CPU shards
    replays the same per-shard key. Bit-equal to the eager() run; within
    the stated limits of the JAX engine."""
    x, lengths = _taps(5, SMALL_N, 11)
    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype(np.int16)
    run = dict(config=SMALL_CFG, chunk_taps=2, device="cpu")
    got = analyze_bundle_pipelined(lambda lo, hi: pcm[lo:hi], lengths, SMALL_N, **run)
    assert stand_in_engine.stats() == {"graphs": 1, "captures": 1, "replays": 2, "evictions": 0, "memory_returns": 0}
    # the graph holds the device constants it captured: the engine's tables
    # and the percentile fractions stay alive if their caches evict them
    (entry,) = stand_in_engine._entries.values()
    cpu = torch.device("cpu")
    for constant in (batch_module._device_tables(SMALL_CFG, SMALL_N, cpu), selectq._fractions((10.0, 50.0, 90.0), cpu)):
        assert any(held is constant for held in entry.held)
    mesh = analyze_bundle_pipelined(lambda lo, hi: pcm[lo:hi], lengths, SMALL_N, mesh=make_mesh(2, platform="cpu"),
                                    **run)
    assert stand_in_engine.stats()["replays"] == 2 + 2 * 2  # 2 chunks of 2 shards
    with eager():
        ref = analyze_bundle_pipelined(lambda lo, hi: pcm[lo:hi], lengths, SMALL_N, **run)
    assert stand_in_engine.stats()["graphs"] == 0  # cleared on entry, nothing captured inside
    for res in (got, mesh):
        assert sorted(res) == sorted(ref)
        for key, value in ref.items():
            np.testing.assert_array_equal(res[key], value, err_msg=key)

    jc = dataclasses.replace(JaxEngineConfig(), run_modal=False)
    assert config_from_jax(jc) == SMALL_CFG
    jax_ref = jax_analyze_batch(jnp.asarray(pcm.astype(np.float32) / 32768.0), jnp.asarray(lengths), jc)
    for key, value in jax_ref.items():
        value = np.asarray(value)
        assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
        if value.dtype != np.float32:
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            rtol, atol = (1e-3, 0.0) if key.startswith("gd_") else (1e-4, 1e-4)
            np.testing.assert_allclose(got[key], value, rtol=rtol, atol=atol, equal_nan=True, err_msg=key)


# ---------------------------------------------- (c) the CPU path is eager ----


def test_the_cpu_engine_never_captures():
    x, lengths = _taps(2, SMALL_N, 3)
    xs, ls = torch.from_numpy(x), torch.from_numpy(lengths)
    before = graphs.STEP_GRAPHS.stats()
    with mock.patch.object(graphs, "capture_cuda", _refuse("capture_cuda")), \
            mock.patch.object(graphs.STEP_GRAPHS, "_capture", _refuse("a capture")):
        first, spec = analyze_batch_flat(xs, ls, SMALL_CFG)
        second, _ = analyze_batch_flat(xs, ls, SMALL_CFG)
    assert graphs.STEP_GRAPHS.stats() == before
    assert not graphs.enabled(torch.device("cpu"))
    torch.testing.assert_close(second, first, rtol=0, atol=0, equal_nan=True)
    direct = batch_module._analyze_batch_flat(xs, ls, SMALL_CFG)
    assert direct[1] == spec
    torch.testing.assert_close(direct[0], first, rtol=0, atol=0, equal_nan=True)


def test_eager_is_a_no_op_on_the_cpu_and_turns_graphs_off_on_the_card(monkeypatch):
    x, lengths = _taps(2, SMALL_N, 4)
    xs, ls = torch.from_numpy(x), torch.from_numpy(lengths)
    outside, spec = analyze_batch_flat(xs, ls, SMALL_CFG)
    cache = graphs.StepGraphs(capture=stand_in_capture, min_calls_ahead=0)
    monkeypatch.setattr(graphs, "STEP_GRAPHS", cache)
    cache.run(_toy_step, *_chunk((2, 2), 0), 1.0)
    (entry,) = cache._entries.values()
    card = torch.device("cuda", 0)
    assert graphs.enabled(card)
    with eager():
        assert cache.keys() == [] and entry.graph.resets == 1
        assert not graphs.enabled(card)
        with eager():
            assert not graphs.enabled(card)
        assert not graphs.enabled(card)
        inside, inside_spec = analyze_batch_flat(xs, ls, SMALL_CFG)
    assert graphs.enabled(card)
    assert inside_spec == spec
    torch.testing.assert_close(inside, outside, rtol=0, atol=0, equal_nan=True)
