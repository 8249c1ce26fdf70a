"""The port's device mesh (audio_analysis_tpu_torch/engine/mesh.py) on a
virtual CPU mesh (`make_mesh(n, platform="cpu")`: n shards of plain torch
versions run one after another) against the JAX package's mesh functions
on its virtual CPU devices (tests/conftest.py gives JAX 8), and against the
port's own single-device engine.

- `analyze_batch_sharded` on 4 shards and 6 decaying-noise taps of 16,384
  samples (so two padded rows), three bands and --bands-decimate, against
  JAX `analyze_batch_sharded(make_mesh(4, platform="cpu"))`: the
  tolerances of tests/test_torch_engine.py, group delay 1e-3 relative
  (every tap is decaying noise). The aggregates at the index's printed
  precision (4 decimals) against JAX, and against numpy's median and mean
  of the per-tap values at 1e-3 relative: numpy and jnp average the two
  middle values of an even count, torch's median would not.
- Mesh against single device in the port at 1e-6, through
  `analyze_batch_sharded` and `analyze_bundle_pipelined(mesh=...)`.
- `analyze_batch_sharded_flat` has `analyze_batch_flat`'s layout of the
  whole chunk.
- The device audio cache under a mesh: an unchanged rerun decodes
  nothing, and entries never cross between mesh and single-device runs.
- `make_mesh` raises when asked for more CUDA devices than are visible
  (the count is mocked), and never falls back to the CPU.
- `run_bundle_report_engine` shards only over the bare
  `cuda` with more than one visible device (count and mesh mocked onto CPU
  shards), and then agrees with the JAX engine report.
"""

import dataclasses
import json
from unittest import mock

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from audio_analysis_tpu.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from audio_analysis_tpu.engine.mesh import analyze_batch_sharded as jax_sharded  # noqa: E402
from audio_analysis_tpu.engine.mesh import make_mesh as jax_make_mesh  # noqa: E402
from audio_analysis_tpu.io.bundle import write_bundle  # noqa: E402
from audio_analysis_tpu_torch.engine import (  # noqa: E402
    EngineConfig,
    analyze_batch,
    analyze_batch_flat,
    analyze_batch_sharded,
    analyze_batch_sharded_flat,
    analyze_bundle_pipelined,
    config_from_jax,
    make_mesh,
    unpack_flat,
)
from audio_analysis_tpu_torch.engine.batch import fetch_packed  # noqa: E402
from audio_analysis_tpu_torch.report import engine_report  # noqa: E402
from test_torch_bundle import METRIC_RTOL, _write_bench_bundle  # noqa: E402
from test_torch_engine import EXACT, _tolerance  # noqa: E402

torch.set_num_threads(2)

SR = 48_000
N = 1 << 14
TAPS = 6
AGGREGATES = ("bundle_median_t30", "bundle_mean_early10", "bundle_valid_taps")
SMALL_CFG = dataclasses.replace(EngineConfig(), run_modal=False)


def _noise_taps(taps: int = TAPS, seed: int = 5):
    rng = np.random.default_rng(seed)
    t = np.arange(N) / SR
    x = np.zeros((taps, 2, N), np.float32)
    for i in range(taps):
        rt60 = 0.15 + 0.03 * i
        x[i, :, 64:] = 0.05 * rng.standard_normal((2, N - 64)) * 10.0 ** (-3.0 * t[: N - 64] / rt60)
        x[i, :, 64] = 0.9
    lengths = (N - 700 * np.arange(taps)).astype(np.int32)
    for i, length in enumerate(lengths):
        x[i, :, length:] = 0.0
    return x, lengths


@pytest.fixture(scope="module", params=["three", "bands_decimate"])
def sharded(request):
    x, lengths = _noise_taps()
    jc = dataclasses.replace(JaxEngineConfig(), bands_decimate=request.param == "bands_decimate")
    ref = {k: np.asarray(v) for k, v in jax_sharded(jax_make_mesh(4, platform="cpu"), x, lengths, jc).items()}
    got = {k: v.numpy() for k, v in analyze_batch_sharded(make_mesh(4, platform="cpu"), x, lengths,
                                                          config_from_jax(jc)).items()}
    return ref, got


def test_sharded_matches_jax_mesh(sharded):
    ref, got = sharded
    assert sorted(got) == sorted(ref)
    for key in ref:
        if key in AGGREGATES:
            continue
        assert got[key].shape == ref[key].shape and got[key].dtype == ref[key].dtype, key
        assert got[key].shape[0] == TAPS, key  # padded rows trimmed
        if key in EXACT or key.endswith("_ok"):
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
            continue
        rtol, atol = (1e-3, 0.0) if key.startswith("gd_") else _tolerance(key)
        np.testing.assert_allclose(got[key], ref[key], rtol=rtol, atol=atol, equal_nan=True, err_msg=key)


def test_sharded_aggregates_follow_numpy(sharded):
    ref, got = sharded
    assert int(got["bundle_valid_taps"]) == int(ref["bundle_valid_taps"]) == TAPS
    t30 = got["t30_rt60"][got["t30_ok"]]
    early = got["early10_time"][got["early10_ok"]]
    assert t30.size % 2 == 0  # an even count: the median averages two values
    for key, numpy_value in (("bundle_median_t30", np.median(t30)), ("bundle_mean_early10", np.mean(early))):
        ours, theirs = float(got[key]), float(ref[key])
        assert f"{ours:.4f}" == f"{theirs:.4f}", key
        assert f"{ours:.4f}" == f"{float(numpy_value):.4f}", key
        assert ours == pytest.approx(float(numpy_value), rel=1e-3), key
    assert float(got["bundle_median_t30"]) != float(np.sort(t30)[t30.size // 2 - 1])  # not the lower middle


@pytest.mark.parametrize("shards", [2, 4])
def test_mesh_matches_single_device(shards):
    x, lengths = _noise_taps()
    one = {k: v.numpy() for k, v in analyze_batch(torch.from_numpy(x), torch.from_numpy(lengths), SMALL_CFG).items()}
    mesh = make_mesh(shards, platform="cpu")
    sharded_out = analyze_batch_sharded(mesh, x, lengths, SMALL_CFG, include_bundle_aggregates=False)
    piped = analyze_bundle_pipelined(lambda lo, hi: x[lo:hi], lengths, N, SMALL_CFG, chunk_taps=1, mesh=mesh)
    for res in (sharded_out, piped):
        assert sorted(res) == sorted(one)
        for key in one:
            value = res[key].numpy() if torch.is_tensor(res[key]) else res[key]
            assert value.dtype == one[key].dtype and value.shape == one[key].shape, key
            np.testing.assert_allclose(value, one[key], rtol=1e-6, atol=1e-6, equal_nan=True, err_msg=key)


def test_flat_round_trip():
    """The sharded flat is analyze_batch_flat's layout of the whole chunk
    (not each shard's blocks one after another), and fetch_packed reads
    two of them."""
    x, lengths = _noise_taps(4)
    mesh = make_mesh(2, platform="cpu")
    flat, spec = analyze_batch_sharded_flat(mesh, x, lengths, SMALL_CFG)
    whole, whole_spec = analyze_batch_flat(torch.from_numpy(x), torch.from_numpy(lengths), SMALL_CFG)
    assert spec == whole_spec and flat.shape == whole.shape
    np.testing.assert_allclose(flat.numpy(), whole.numpy(), rtol=1e-6, atol=1e-6, equal_nan=True)
    direct = analyze_batch_sharded(mesh, x, lengths, SMALL_CFG, include_bundle_aggregates=False)
    for res in [unpack_flat(flat.numpy(), spec)] + fetch_packed([flat, flat], spec):
        assert list(res) == sorted(direct)
        for key, value in direct.items():
            assert res[key].dtype == value.numpy().dtype, key
            np.testing.assert_array_equal(res[key], value.numpy(), err_msg=key)
    with pytest.raises(ValueError, match="not divisible"):
        analyze_batch_sharded_flat(mesh, x[:3], lengths[:3], SMALL_CFG)


def test_device_audio_cache_under_mesh(tmp_path):
    """The engine report's per-chunk cache over the pipelined entry: 6 taps
    at 1 tap per shard on 4 shards are 2 chunks of 4 taps; an unchanged
    rerun serves both from the cache (no decode), the single-device run
    after it (6 chunks of 1 tap) reuses nothing, and the mesh run after
    that nothing either."""
    x, lengths = _noise_taps()
    root = write_bundle(tmp_path / "b", {f"tap{i}": x[i].T for i in range(TAPS)}, SR)
    names = [f"tap{i}" for i in range(TAPS)]
    mesh = make_mesh(4, platform="cpu")
    cpu = torch.device("cpu")
    loads = []

    def loader(lo, hi):
        loads.append((lo, hi))
        return x[lo:hi]

    def run(run_mesh):
        cache = engine_report._device_audio_chunks(root, names, 1, N, cpu, run_mesh)
        out = analyze_bundle_pipelined(loader, lengths, N, SMALL_CFG, 1, mesh=run_mesh,
                                       device_chunk_cache=cache, device=cpu)
        return out, cache

    first, cache = run(mesh)
    assert (cache.reused, cache.uploaded) == (0, 2) and sorted(loads) == [(0, 4), (4, 6)]
    entry = engine_report._DEVICE_AUDIO_CACHE["entries"][0][1]
    assert len(entry) == 4 and all(block.shape[0] == 1 for block in entry)  # one block per shard
    second, cache = run(mesh)
    assert (cache.reused, cache.uploaded) == (2, 0) and len(loads) == 2
    single, cache = run(None)  # 1 tap a chunk on one device
    assert (cache.reused, cache.uploaded) == (0, TAPS) and len(loads) == 2 + TAPS
    _again, cache = run(mesh)
    assert (cache.reused, cache.uploaded) == (0, 2) and len(loads) == 4 + TAPS
    for key in first:
        np.testing.assert_array_equal(second[key], first[key], err_msg=key)
        np.testing.assert_allclose(single[key], first[key], rtol=1e-6, atol=1e-6, equal_nan=True, err_msg=key)


def test_make_mesh_refuses_missing_cuda_devices():
    with mock.patch.object(torch.cuda, "device_count", return_value=1):
        with pytest.raises(ValueError, match="Requested 2 CUDA devices but only 1 are visible"):
            make_mesh(2)
        with pytest.raises(ValueError, match="cuda:1 is not one of the 1 visible"):
            make_mesh(devices=["cuda:0", "cuda:1"])
        assert make_mesh(devices=["cuda:0", "cuda:0"]) == (torch.device("cuda", 0),) * 2
        assert make_mesh() == (torch.device("cuda", 0),)
    with mock.patch.object(torch.cuda, "device_count", return_value=0):
        with pytest.raises(ValueError, match="only 0 are visible"):
            make_mesh()
    assert make_mesh(3, platform="cpu") == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="unknown mesh platform"):
        make_mesh(2, platform="tpu")


def test_engine_report_auto_mesh_matches_jax(tmp_path):
    """The bare `cuda` with 4 visible devices (mocked) builds the mesh
    (mocked onto 4 CPU shards); `cpu`, `cuda:1` and the bare `cuda` with
    one visible device do not. 5 taps at 1
    tap per shard: the second chunk is padded. The report's metrics agree
    with the JAX engine report's."""
    from audio_analysis_tpu.report import EngineBundleSettings as JaxSettings
    from audio_analysis_tpu.report import run_bundle_report_engine as jax_report

    root = _write_bench_bundle(tmp_path / "b", 5, N)
    calls = []

    def cpu_mesh():
        calls.append(1)
        return make_mesh(4, platform="cpu")

    settings = engine_report.EngineBundleSettings(reports_subdir="reports_mesh", chunk_taps=1)
    with mock.patch.object(torch.cuda, "device_count", return_value=4), \
            mock.patch.object(engine_report, "make_mesh", cpu_mesh):
        engine_report.run_bundle_report_engine(root, settings, device="cuda")
        assert len(calls) == 1
        engine_report.run_bundle_report_engine(root, dataclasses.replace(settings, reports_subdir="r_cpu"), "cpu")
        assert engine_report._engine_mesh(torch.device("cuda", 1)) is None
        assert engine_report._engine_mesh(torch.device("cpu")) is None
        assert len(calls) == 1
    with mock.patch.object(torch.cuda, "device_count", return_value=1), \
            mock.patch.object(engine_report, "make_mesh", cpu_mesh):
        assert engine_report._engine_mesh(torch.device("cuda")) is None
        assert len(calls) == 1
    jax_report(root, JaxSettings(reports_subdir="reports_jax", chunk_taps=1, use_device_mesh="off"))
    ours = json.loads((root / "reports_mesh" / "bundle_metrics.json").read_text())
    theirs = json.loads((root / "reports_jax" / "bundle_metrics.json").read_text())
    assert ours["taps"] == theirs["taps"] and list(ours["metrics"]) == list(theirs["metrics"])
    for key, ref in theirs["metrics"].items():
        a, b = np.asarray(ours["metrics"][key]), np.asarray(ref)
        assert a.shape == b.shape and a.dtype == b.dtype, key
        if a.dtype != np.float64:
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            np.testing.assert_allclose(a, b, rtol=METRIC_RTOL.get(key, 1e-4), atol=1e-4, equal_nan=True, err_msg=key)
