"""Spectrum-crop band decimation in the port (ops/fftmask and
EngineConfig(bands_decimate=True)) against the JAX package on the CPU.

- band_decimation_factors and crop_half_masks: bit-identical to the JAX
  functions, in the three band modes at N = 2^20 and at the test N;
- banded_from_spectrum (real and packed stereo, k = 1, 2, 4): within 1e-5
  of the max of the JAX result (two FFT libraries at 2^16 points), and a
  decimated band signal equals every k-th sample of the full-rate one to
  5e-6 of its max (float32 FFT rounding; the crop drops only zero bins);
- analyze_batch with bands_decimate against the JAX engine on the same
  config, on the well-conditioned taps of tests/test_torch_engine.py
  (parity_matrix's modal and damped IRs and a decaying-noise tap):
  every *_ok flag exact, band RT60s within 1e-4 relative, the full-rate
  band tolerance of tests/test_torch_engine.py (the same algorithm on
  both sides; only the FFT libraries differ);
- K1 runs once per decimation group (and once for the broadband decay),
  and the decimated fits agree with the full-rate ones within 5e-3
  relative on clean single-mode band decays (the JAX package's own test
  of the same property).
"""

import dataclasses
from functools import lru_cache
from unittest import mock

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from audio_analysis_tpu.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from audio_analysis_tpu.engine import analyze_batch as jax_analyze_batch  # noqa: E402
from audio_analysis_tpu.engine.batch import _band_masks as jax_band_masks  # noqa: E402
from audio_analysis_tpu.ops import fftmask as jax_fftmask  # noqa: E402
from audio_analysis_tpu_torch.engine import EngineConfig, analyze_batch, config_from_jax  # noqa: E402
from audio_analysis_tpu_torch.engine.batch import band_masks  # noqa: E402
from audio_analysis_tpu_torch.ops import edc, fftmask  # noqa: E402
from test_torch_engine import N, _inputs  # noqa: E402

torch.set_num_threads(2)

SR = 48_000
MODES = ("three", "octave", "third")
BANDS_ONLY = dict(run_stft=False, run_modal=False, run_diffusion=False, run_fr=False, run_group_delay=False)


@lru_cache(maxsize=8)
def _masks(mode: str, n: int):
    """(JAX mask matrix, port mask matrix) of one band mode at length n."""
    jax_masks = jax_band_masks(JaxEngineConfig(band_mode=mode), n)
    return jax_masks, band_masks(EngineConfig(band_mode=mode), n)


@pytest.mark.parametrize("n", [1 << 20, N])
@pytest.mark.parametrize("mode", MODES)
def test_decimation_factors_match_jax(mode, n):
    jax_masks, masks = _masks(mode, n)
    assert np.array_equal(masks, jax_masks)
    factors = fftmask.band_decimation_factors(masks, n)
    assert factors == jax_fftmask.band_decimation_factors(jax_masks, n)
    assert max(factors) > 1  # every mode decimates some band at these lengths
    if (mode, n) == ("three", 1 << 20):
        assert factors == (32, 4, 1)


@pytest.mark.parametrize("n", [1 << 20, N])
@pytest.mark.parametrize("mode", MODES)
def test_crop_half_masks_match_jax(mode, n):
    jax_masks, masks = _masks(mode, n)
    for k in sorted(set(fftmask.band_decimation_factors(masks, n)) | {2}):
        got = fftmask.crop_half_masks(masks, n, k)
        ref = jax_fftmask.crop_half_masks(jax_masks, n, k)
        assert got.dtype == ref.dtype and got.shape == ref.shape == (masks.shape[0], n // k // 2 + 1)
        assert np.array_equal(got, ref), k


def _signal(channels: int, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((channels, n)).astype(np.float32)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("channels", [1, 2])
def test_banded_from_spectrum_matches_jax(channels, k):
    x = _signal(channels, N, 3 + k)
    masks = fftmask.crop_half_masks(_masks("three", N)[1], N, k)
    kind, spectrum = fftmask.full_band_spectrum(torch.from_numpy(x))
    jkind, jspectrum = jax_fftmask.full_band_spectrum(jnp.asarray(x))
    assert kind == jkind == ("packed" if channels == 2 else "real")
    got = fftmask.banded_from_spectrum(kind, spectrum, torch.from_numpy(masks), N, k).numpy()
    ref = np.asarray(jax_fftmask.banded_from_spectrum(jkind, jspectrum, jnp.asarray(masks), N, k))
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float32
    assert np.max(np.abs(got - ref)) <= 1e-5 * np.max(np.abs(ref))


@pytest.mark.parametrize("channels", [1, 2])
def test_decimated_band_signal_is_every_kth_sample(channels):
    """The cropped inverse equals the full-rate band signal sampled every
    k-th instant (min_length lowered so the crop goes deep at 2^16)."""
    x = torch.from_numpy(_signal(channels, N, 5))
    masks = _masks("three", N)[1]
    full = fftmask.apply_band_masks(x, torch.from_numpy(masks)).numpy()
    kind, spectrum = fftmask.full_band_spectrum(x)
    factors = fftmask.band_decimation_factors(masks, N, min_length=2048)
    assert max(factors) >= 16
    for i, k in enumerate(factors):
        cropped = torch.from_numpy(fftmask.crop_half_masks(masks[i : i + 1], N, k))
        got = fftmask.banded_from_spectrum(kind, spectrum, cropped, N, k).numpy()[..., 0, :]
        ref = full[..., i, ::k]
        assert np.max(np.abs(got - ref)) <= 5e-6 * np.max(np.abs(ref)), (i, k)


@pytest.fixture(scope="module", params=MODES)
def decimated(request):
    x, lengths = _inputs()
    jc = JaxEngineConfig(band_mode=request.param, bands_decimate=True, **BANDS_ONLY)
    ref = {k: np.asarray(v) for k, v in jax_analyze_batch(jnp.asarray(x), jnp.asarray(lengths), jc).items()}
    got = {
        k: v.numpy()
        for k, v in analyze_batch(torch.from_numpy(x), torch.from_numpy(lengths), config_from_jax(jc)).items()
    }
    return ref, got


def test_decimated_engine_flags_and_shapes_exact(decimated):
    ref, got = decimated
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape and got[key].dtype == ref[key].dtype, key
        if key.endswith("_ok") or key in ("start_index", "segment_length"):
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_decimated_engine_band_rt60_within_tolerance(decimated):
    ref, got = decimated
    for key in ("band_t30_rt60", "band_t20_rt60", "band_edt_rt60"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-4, equal_nan=True, err_msg=key)


@pytest.mark.parametrize("mode", MODES)
def test_k1_runs_once_per_decimation_group(mode):
    """One EDC call for the broadband decay and one per decimation group
    (per tap in octave/third mode), each on a plane N/k long."""
    x, lengths = _inputs()
    cfg = EngineConfig(band_mode=mode, bands_decimate=True, **BANDS_ONLY)
    factors = fftmask.band_decimation_factors(band_masks(cfg, N), N)
    groups = sorted(set(factors))
    shapes = []

    def spy(samples, *args):
        shapes.append(tuple(samples.shape))
        return real(samples, *args)

    real = edc.schroeder_edc_db
    with mock.patch.object(edc, "schroeder_edc_db", spy):
        analyze_batch(torch.from_numpy(x), torch.from_numpy(lengths), cfg)
    taps = x.shape[0]
    per_tap = mode != "three"
    group_calls = [
        ((2, factors.count(k), N // k) if per_tap else (taps, 2, factors.count(k), N // k)) for k in groups
    ]
    assert shapes == [(taps, 2, N)] + group_calls * (taps if per_tap else 1)


def test_no_decimation_below_min_length():
    """At N = 2^14 no band can decimate (N/2 < 16384): the flag changes
    nothing."""
    x, lengths = _inputs()
    n = 1 << 14
    x, lengths = np.ascontiguousarray(x[..., :n]), np.minimum(lengths, n)
    cfg = EngineConfig(**BANDS_ONLY)
    full = analyze_batch(torch.from_numpy(x), torch.from_numpy(lengths), cfg)
    dec = analyze_batch(torch.from_numpy(x), torch.from_numpy(lengths), dataclasses.replace(cfg, bands_decimate=True))
    for key in full:
        torch.testing.assert_close(dec[key], full[key], rtol=0, atol=0, equal_nan=True)


def _banded_sine_batch(band_defs, n, taps=3):
    """One decaying sinusoid per band centre (rt60 0.25 + 0.03 j + 0.02
    tap), with an alignment impulse at a k-divisible peak."""
    t = np.arange(n) / SR
    peak = 1024
    batch = np.zeros((taps, 2, n), np.float32)
    for tap in range(taps):
        sig = np.zeros((2, n))
        for j, band in enumerate(band_defs):
            env = 10.0 ** (-3.0 * t / (0.25 + 0.03 * j + 0.02 * tap))
            for ch in range(2):
                sig[ch] += 0.2 * np.sin(2.0 * np.pi * band.centre_hz * t + 0.7 * j + 1.3 * ch + 0.4 * tap) * env
        sig[:, :peak] = 0.0
        sig[:, peak] = 0.9
        batch[tap] = sig.astype(np.float32)
    return batch, np.array([n, n, n - 4096][:taps], np.int32)


@pytest.mark.parametrize("mode", ["three", "octave"])
def test_decimated_fits_match_full_rate(mode):
    """Decimated band fits against the full-rate ones on clean band decays,
    where the full-rate fit recovers the fixture's rt60 (within 2x)."""
    n = 1 << 17
    band_defs = (
        fftmask.build_three_band_definitions(SR)
        if mode == "three"
        else fftmask.build_fractional_octave_band_definitions(SR, 1)
    )
    batch, lengths = _banded_sine_batch(band_defs, n)
    cfg = EngineConfig(band_mode=mode, **BANDS_ONLY)
    full = analyze_batch(torch.from_numpy(batch), torch.from_numpy(lengths), cfg)
    dec = analyze_batch(torch.from_numpy(batch), torch.from_numpy(lengths), dataclasses.replace(cfg, bands_decimate=True))
    assert max(fftmask.band_decimation_factors(band_masks(cfg, n), n)) > 1
    taps, channels, num_bands = full["band_t30_rt60"].shape
    expected = np.array([[0.25 + 0.03 * j + 0.02 * tap for j in range(num_bands)] for tap in range(taps)])
    expected = np.broadcast_to(expected[:, None, :], (taps, channels, num_bands))
    compared = 0
    for key in ("band_t30_rt60", "band_t20_rt60", "band_edt_rt60"):
        ok_key = key.replace("_rt60", "_ok")
        np.testing.assert_array_equal(full[ok_key].numpy(), dec[ok_key].numpy(), err_msg=key)
        a, b = full[key].numpy(), dec[key].numpy()
        meaningful = full[ok_key].numpy() & (np.abs(a - expected) < 0.5 * expected)
        compared += int(meaningful.sum())
        np.testing.assert_allclose(b[meaningful], a[meaningful], rtol=5e-3, err_msg=key)
    assert compared > 3 * taps * channels * (num_bands // 2)
