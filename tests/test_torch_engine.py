"""The port's fused engine (audio_analysis_tpu_torch.engine.analyze_batch)
against audio_analysis_tpu.engine.analyze_batch on the CPU, in the three
band modes and with the on-device mono downmix, plus the port's host
entries (flat packing, pipelined chunking, the device audio cache, a mesh
of CPU shards).

Inputs are the well-conditioned taps of tests/parity_matrix.py (modal and
damped IRs) and a decaying-noise tap (rt60 1.2 s, as in bench.py), so fits
do not sit on noise-driven knife edges.

Tolerances, each with its reason:
- start_index, segment_length, *_num_frames, modal_count, peak_abs and
  every *_ok flag: exact (integer and selection logic on the same samples);
- broadband decay metrics: 1e-5 relative (float32 sums in another order);
- band RT60s: 1e-4 relative (2^16-point FFTs of two libraries feed the
  band EDC and fits);
- fr_peak_hz 1e-6 relative, fr_centroid_hz 1e-4 relative;
- stft_global_max_db: 1e-4 dB absolute;
- modal aggregates 1e-3 relative; per-bin modal_rt60 / modal_r2 1e-2
  relative with identical NaN positions: the JAX engine's default matmul
  FFT and torch.fft differ at 1e-7 in magnitude, and fits over 10-20
  frames of a bin amplify that;
- diffusion medians: 1e-4 absolute (normalised correlations and densities);
- group delay: 1e-3 relative on the decaying-noise tap only. On the tonal
  IRs the float32 phase at deep spectral nulls is noise: the JAX package's
  own float32 percentiles differ from a float64 evaluation of the same
  definition by more than 100% there, so those taps are only held to
  finite values.
"""

import dataclasses

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from audio_analysis_tpu.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from audio_analysis_tpu.engine import analyze_batch as jax_analyze_batch  # noqa: E402
from audio_analysis_tpu_torch.engine import (  # noqa: E402
    EngineConfig,
    analyze_batch,
    analyze_batch_flat,
    analyze_bundle,
    analyze_bundle_pipelined,
    config_from_jax,
    make_mesh,
    unpack_flat,
)
from parity_matrix import make_damped_ir, make_modal_ir  # noqa: E402

torch.set_num_threads(2)

SR = 48_000
N = 1 << 16
NOISE_TAP = 2

EXACT = {"start_index", "segment_length", "stft_num_frames", "diff_num_frames", "modal_count", "peak_abs"}
RTOL = {
    "fr_peak_hz": 1e-6,
    "fr_centroid_hz": 1e-4,
    "modal_median_rt60": 1e-3,
    "modal_p90_rt60": 1e-3,
    "modal_max_rt60": 1e-3,
    "modal_rt60": 1e-2,
    "modal_r2": 1e-2,
}
ATOL = {"stft_global_max_db": 1e-4}


def _pad(ir: np.ndarray) -> np.ndarray:
    out = np.zeros((2, N), np.float32)
    take = min(N, ir.shape[0])
    out[:, :take] = ir[:take].T
    return out


def _noise_tap(seed: int, rt60: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(N) / SR
    x = np.zeros((2, N), np.float32)
    x[:, 256:] = 0.05 * rng.standard_normal((2, N - 256)) * 10.0 ** (-3.0 * t[: N - 256] / rt60)
    x[:, 256] = 0.9
    return x


def _inputs():
    x = np.stack([_pad(make_modal_ir()), _pad(make_damped_ir()), _noise_tap(3, 1.2)])
    lengths = np.array([N, N - 5000, N - 12345], np.int32)
    for i, length in enumerate(lengths):
        x[i, :, length:] = 0.0
    return x, lengths


def _tolerance(key):
    if key in RTOL:
        return RTOL[key], 0.0
    if key in ATOL:
        return 0.0, ATOL[key]
    if key.startswith("band_"):
        return 1e-4, 0.0
    if key.startswith("diff_"):
        return 0.0, 1e-4
    return 1e-5, 1e-6


CASES = {
    "three": {"band_mode": "three"},
    "octave": {"band_mode": "octave"},
    "third": {"band_mode": "third"},
    "mono": {"band_mode": "three", "downmix_to_mono": True},
}


@pytest.fixture(scope="module", params=sorted(CASES))
def both(request):
    x, lengths = _inputs()
    jc = dataclasses.replace(JaxEngineConfig(), **CASES[request.param])
    ref = {k: np.asarray(v) for k, v in jax_analyze_batch(jnp.asarray(x), jnp.asarray(lengths), jc).items()}
    got = {
        k: v.numpy()
        for k, v in analyze_batch(torch.from_numpy(x), torch.from_numpy(lengths), config_from_jax(jc)).items()
    }
    return request.param, ref, got


def test_keys_shapes_dtypes_identical(both):
    _case, ref, got = both
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape, key
        assert got[key].dtype == ref[key].dtype, key


def test_exact_outputs(both):
    _case, ref, got = both
    for key in ref:
        if key in EXACT or key.endswith("_ok"):
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_metrics_within_tolerance(both):
    _case, ref, got = both
    for key in ref:
        if key in EXACT or key.endswith("_ok") or key.startswith("gd_"):
            continue
        rtol, atol = _tolerance(key)
        np.testing.assert_allclose(got[key], ref[key], rtol=rtol, atol=atol, equal_nan=True, err_msg=key)


def test_group_delay(both):
    _case, ref, got = both
    for key in ("gd_p10", "gd_median", "gd_p90"):
        assert np.all(np.isfinite(got[key])), key
        np.testing.assert_allclose(got[key][NOISE_TAP], ref[key][NOISE_TAP], rtol=1e-3, err_msg=key)


def test_int16_input_scales_on_device():
    x, lengths = _inputs()
    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype(np.int16)
    cfg = dataclasses.replace(EngineConfig(), run_bands=False, run_modal=False)
    got = analyze_batch(torch.from_numpy(pcm), torch.from_numpy(lengths), cfg)
    ref = analyze_batch(torch.from_numpy(pcm.astype(np.float32) / 32768.0), torch.from_numpy(lengths), cfg)
    for key in ref:
        torch.testing.assert_close(got[key], ref[key], rtol=0, atol=0, equal_nan=True)


# ---------------------------------------------------------- host entries ----

SMALL_N = 1 << 14
SMALL_CFG = dataclasses.replace(EngineConfig(), run_modal=False)


def _small_bundle(taps: int):
    rng = np.random.default_rng(11)
    t = np.arange(SMALL_N) / SR
    x = np.zeros((taps, 2, SMALL_N), np.float32)
    x[:, :, 64:] = 0.05 * rng.standard_normal((taps, 2, SMALL_N - 64)) * 10.0 ** (
        -3.0 * t[: SMALL_N - 64] / 0.3
    )
    x[:, :, 64] = 0.9
    lengths = (SMALL_N - 300 * np.arange(taps)).astype(np.int32)
    for i, length in enumerate(lengths):
        x[i, :, length:] = 0.0
    return np.clip(np.round(x * 32767.0), -32768, 32767).astype(np.int16), lengths


def test_unpack_flat_restores_dtypes_and_shapes():
    pcm, lengths = _small_bundle(2)
    direct = analyze_batch(torch.from_numpy(pcm), torch.from_numpy(lengths), SMALL_CFG)
    flat, spec = analyze_batch_flat(torch.from_numpy(pcm), torch.from_numpy(lengths), SMALL_CFG)
    assert flat.dtype == torch.float32 and flat.ndim == 1
    out = unpack_flat(flat.numpy(), spec)
    assert [k for k, _s, _d in spec] == sorted(direct)
    for key, value in direct.items():
        ref = value.numpy()
        assert out[key].dtype == ref.dtype and out[key].shape == ref.shape, key
        np.testing.assert_array_equal(out[key], ref, err_msg=key)


class _DictCache:
    def __init__(self):
        self.entries = {}
        self.hits = 0

    def get(self, idx):
        hit = self.entries.get(idx)
        self.hits += hit is not None
        return hit

    def put(self, idx, arr):
        self.entries[idx] = arr


@pytest.mark.parametrize("prefetch", [1, 2])
def test_pipelined_chunks_match_one_batch(prefetch):
    """5 taps in chunks of 2 (a padded final chunk), with the per-chunk
    callback and the device audio cache; a second run serves every chunk
    from the cache. Results equal one analyze_batch over all taps."""
    pcm, lengths = _small_bundle(5)
    one = {
        k: v.numpy()
        for k, v in analyze_batch(torch.from_numpy(pcm), torch.from_numpy(lengths), SMALL_CFG).items()
    }
    calls = []
    loads = []

    def loader(lo, hi):
        loads.append((lo, hi))
        return pcm[lo:hi]

    cache = _DictCache()
    timings = {}
    kwargs = dict(
        config=SMALL_CFG, chunk_taps=2, device_chunk_cache=cache, prefetch_chunks=prefetch,
        device="cpu",
    )
    out = analyze_bundle_pipelined(
        loader, lengths, SMALL_N, timings=timings,
        on_chunk_result=lambda lo, hi, res: calls.append((lo, hi, res["start_index"].shape[0])),
        **kwargs,
    )
    assert sorted(calls) == [(0, 2, 2), (2, 4, 2), (4, 5, 1)]
    assert sorted(loads) == [(0, 2), (2, 4), (4, 5)]
    assert {"decode_wait_s", "h2d_dispatch_s", "fetch_s", "chunk_callback_s"} <= set(timings)
    again = analyze_bundle_pipelined(loader, lengths, SMALL_N, **kwargs)
    assert cache.hits == 3 and len(loads) == 3
    for res in (out, again):
        assert sorted(res) == sorted(one)
        for key in one:
            assert res[key].dtype == one[key].dtype and res[key].shape == one[key].shape, key
            np.testing.assert_allclose(res[key], one[key], rtol=1e-6, atol=1e-6, equal_nan=True, err_msg=key)

    whole = analyze_bundle(pcm, lengths, SMALL_CFG, chunk_taps=3, device="cpu")
    for key in one:
        np.testing.assert_allclose(whole[key], one[key], rtol=1e-6, atol=1e-6, equal_nan=True, err_msg=key)


def test_not_yet_ported_options_raise():
    """`mesh=` is ported: 5 taps on a mesh of 2 CPU shards at 2 taps a
    shard (a padded final chunk) equal one analyze_batch over all taps."""
    pcm, lengths = _small_bundle(5)
    one = {
        k: v.numpy()
        for k, v in analyze_batch(torch.from_numpy(pcm), torch.from_numpy(lengths), SMALL_CFG).items()
    }
    mesh = make_mesh(2, platform="cpu")
    out = analyze_bundle_pipelined(lambda lo, hi: pcm[lo:hi], lengths, SMALL_N, SMALL_CFG, 2, mesh=mesh)
    whole = analyze_bundle(pcm, lengths, SMALL_CFG, chunk_taps=1, mesh=mesh)
    for res in (out, whole):
        assert sorted(res) == sorted(one)
        for key in one:
            assert res[key].dtype == one[key].dtype and res[key].shape == one[key].shape, key
            np.testing.assert_allclose(res[key], one[key], rtol=1e-6, atol=1e-6, equal_nan=True, err_msg=key)
