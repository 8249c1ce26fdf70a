"""Module-by-module parity of the torch port (audio_analysis_tpu_torch.ops,
engine.config) against the JAX package on the CPU: the same numpy inputs,
made from a seed, go through both.

Tolerances, each with its reason:
- trim, selectq, crossing indices and the numpy tables: exact (the same
  integer/float32 arithmetic, or copies of the same numpy code);
- decay fits: 1e-5 relative (float32 sums over up to 2^15 points, reduced
  in another order);
- filterbank: 1e-6 of the signal peak (2^15-point FFTs of two libraries);
- diffusion: 1e-5 absolute on normalised correlations and densities
  (2^12-point FFTs; the JAX side uses the xla FFT here).
"""

import dataclasses

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from audio_analysis_tpu.analyses import waterfall as jwaterfall  # noqa: E402
from audio_analysis_tpu.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from audio_analysis_tpu.engine import batch as jbatch  # noqa: E402
from audio_analysis_tpu.ops import dbfit as jdbfit  # noqa: E402
from audio_analysis_tpu.ops import diffusion as jdiffusion  # noqa: E402
from audio_analysis_tpu.ops import fftmask as jfftmask  # noqa: E402
from audio_analysis_tpu.ops import logfreq as jlogfreq  # noqa: E402
from audio_analysis_tpu.ops import selectq as jselectq  # noqa: E402
from audio_analysis_tpu.ops import stft as jstft  # noqa: E402
from audio_analysis_tpu.ops import trim as jtrim  # noqa: E402
from audio_analysis_tpu_torch.engine import batch as tbatch  # noqa: E402
from audio_analysis_tpu_torch.engine.config import (  # noqa: E402
    TPU_ONLY_FIELDS,
    EngineConfig,
    config_from_jax,
)
from audio_analysis_tpu_torch.ops import (  # noqa: E402
    common,
    dbfit,
    diffusion,
    fftmask,
    logfreq,
    selectq,
    stft,
    trim,
)
from audio_analysis_tpu_torch.report import waterfall  # noqa: E402

torch.set_num_threads(2)

SR = 48_000


def _t(a):
    return torch.from_numpy(np.array(a))


def _decaying_noise(shape, n, seed, rt60=0.8, onset=300):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = np.zeros(shape + (n,), np.float32)
    x[..., onset:] = 0.05 * rng.standard_normal(shape + (n - onset,)) * 10.0 ** (
        -3.0 * t[: n - onset] / rt60
    )
    x[..., onset] = 0.9
    return x


# ---------------------------------------------------------------- config ----


def test_config_from_jax_equals_default():
    assert config_from_jax(JaxEngineConfig()) == EngineConfig()


def test_config_fields_and_defaults_match_jax():
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxEngineConfig)}
    ours = {f.name: f.default for f in dataclasses.fields(EngineConfig)}
    for name in TPU_ONLY_FIELDS:
        assert name in jax_fields
        jax_fields.pop(name)
    assert ours == jax_fields


def test_config_from_jax_carries_overrides():
    jc = dataclasses.replace(JaxEngineConfig(), band_mode="third", stft_fft_impl="xla", n_fft=2048)
    cfg = config_from_jax(jc)
    assert cfg.band_mode == "third" and cfg.n_fft == 2048


# ---------------------------------------------------------------- tables ----


@pytest.mark.parametrize("band_mode", ["three", "octave", "third"])
@pytest.mark.parametrize("n", [1 << 16, 1 << 20])
def test_band_mask_matrix_bit_identical(band_mode, n):
    jc = dataclasses.replace(JaxEngineConfig(), band_mode=band_mode)
    ours = tbatch.band_masks(config_from_jax(jc), n)
    theirs = jbatch._band_masks(jc, n)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    assert np.array_equal(ours, theirs)
    assert tbatch.band_names(config_from_jax(jc)) == jbatch.band_names(jc)


@pytest.mark.parametrize("trim_bins", [True, False])
def test_modal_tables_bit_identical(trim_bins):
    jc = dataclasses.replace(JaxEngineConfig(), modal_trim_bins=trim_bins)
    c_ours, m_ours, ne_ours = logfreq.modal_bin_matrix(config_from_jax(jc))
    c_theirs, m_theirs, ne_theirs = jbatch._modal_bin_matrix(jc)
    for a, b in ((c_ours, c_theirs), (m_ours, m_theirs), (ne_ours, ne_theirs)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    edges = logfreq.build_log_bin_edges(20.0, 20000.0, 24, 24)
    assert np.array_equal(edges, jlogfreq.build_log_bin_edges(20.0, 20000.0, 24, 24))


@pytest.mark.parametrize("n_fft", [256, 4096, 8192])
def test_hann_window_and_freq_tables_bit_identical(n_fft):
    assert np.array_equal(stft.hann_window(n_fft), jstft.hann_window(n_fft))
    assert np.array_equal(stft.rfft_freqs_hz(n_fft, SR), jstft.rfft_freqs_hz(n_fft, SR))
    assert np.array_equal(
        stft.frame_times_seconds(2041, 512, SR), jstft.frame_times_seconds(2041, 512, SR)
    )


def test_dynamic_hann_window_matches_jax():
    lengths = np.array([[65536, 1000], [2, 0]], np.int32)
    got = common.hann_window_dynamic(4096, _t(lengths)).numpy()
    ref = np.asarray(jax.jit(lambda l: jbatch.hann_window_dynamic(4096, l))(jnp.asarray(lengths)))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_allclose(got[0, 1, :1000], np.hanning(1000), atol=1e-6)


@pytest.mark.parametrize("mode", ["auto", "uniform_time", "uniform_frames"])
@pytest.mark.parametrize("frames", [0, 1, 120, 2041])
def test_waterfall_slice_selection_matches_jax(mode, frames):
    times = stft.frame_times_seconds(frames, 512, SR)
    ours = waterfall.select_slice_frame_indices(
        times, waterfall.WaterfallAnalysisSettings(slice_mode=mode)
    )
    theirs = jwaterfall.select_slice_frame_indices(
        times, jwaterfall.WaterfallAnalysisSettings(slice_mode=mode)
    )
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    assert dataclasses.asdict(waterfall.WaterfallAnalysisSettings()) == dataclasses.asdict(
        jwaterfall.WaterfallAnalysisSettings()
    )


# ------------------------------------------------------------------ trim ----


def test_trim_peak_shift_and_align_exact():
    rng = np.random.default_rng(0)
    n = 4096
    x = rng.standard_normal((3, 2, n)).astype(np.float32)
    x[0, 0, [100, 900]] = 50.0  # two equal maxima: the first one wins
    x[1, 1, 3000] = -60.0  # past the valid length: ignored
    lengths = np.array([[n, n], [n, 2000], [700, 0]], np.int32)

    got_peak = trim.peak_index(_t(x), _t(lengths)).numpy()
    ref_peak = np.asarray(jtrim.peak_index(jnp.asarray(x), jnp.asarray(lengths)))
    np.testing.assert_array_equal(got_peak, ref_peak)
    assert got_peak.dtype == np.int32 and got_peak[0, 0] == 100

    starts = np.array([[0, 5000], [-3, 100], [4096, 17]], np.int32)
    got = trim.shift_to(_t(x), _t(starts), _t(lengths))
    ref = jtrim.shift_to(jnp.asarray(x), jnp.asarray(starts), jnp.asarray(lengths))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    for trim_to_peak, ignore in ((True, 0.0), (True, 0.01), (False, 0.02)):
        got = trim.align_for_analysis(_t(x), _t(lengths), SR, trim_to_peak, ignore)
        ref = jtrim.align_for_analysis(jnp.asarray(x), jnp.asarray(lengths), SR, trim_to_peak, ignore)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ----------------------------------------------------------------- dbfit ----


def _edc_curves():
    n = 1 << 15
    x = _decaying_noise((2, 2), n, 4, rt60=0.6)
    lengths = np.array([[n, n - 3000], [20000, n]], np.int32)
    for idx in np.ndindex(2, 2):
        x[idx][lengths[idx]:] = 0.0
    with jax.default_device(jax.devices("cpu")[0]):
        from audio_analysis_tpu.ops import edc as jedc

        curve = np.asarray(jedc.schroeder_edc_db(jnp.asarray(x), jnp.asarray(lengths)).edc_db)
    return curve, lengths


@pytest.mark.parametrize("target", [0.0, -10.0, -35.0, -200.0])
def test_crossing_time_matches_jax(target):
    curve, lengths = _edc_curves()
    got = dbfit.crossing_time(_t(curve), _t(lengths), target, SR)
    ref = jdbfit.crossing_time(jnp.asarray(curve), jnp.asarray(lengths), target, SR)
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(ref.found))
    np.testing.assert_allclose(got.time_seconds.numpy(), np.asarray(ref.time_seconds), rtol=1e-6)


@pytest.mark.parametrize("range_db,min_points", [((-5.0, -35.0), 8), ((0.0, -10.0), 8), ((-5.0, -25.0), 40000)])
def test_decay_fit_matches_jax(range_db, min_points):
    curve, lengths = _edc_curves()
    got = dbfit.fit_decay_slope_over_db_range(_t(curve), _t(lengths), range_db, -80.0, SR, min_points)
    ref = jdbfit.fit_decay_slope_over_db_range(
        jnp.asarray(curve), jnp.asarray(lengths), range_db, -80.0, SR, min_points
    )
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    np.testing.assert_array_equal(got.num_points.numpy(), np.asarray(ref.num_points))
    assert got.num_points.dtype == torch.int32
    for name in ("slope_db_per_second", "rt60_seconds", "r_squared", "start_time_seconds", "end_time_seconds"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)), rtol=1e-5, atol=1e-6
        )


# --------------------------------------------------------------- selectq ----


def test_masked_percentiles_exact_vs_numpy_and_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 1001)).astype(np.float32) * 100.0
    valid = rng.random((4, 1001)) > 0.3
    x[0, 3] = np.nan
    x[1, :] = np.float32(7.0)  # ties everywhere
    valid[2, :] = False  # nothing valid -> NaN
    valid[3, :] = False
    valid[3, 10] = True  # one valid element
    qs = (10.0, 50.0, 90.0)
    got = selectq.masked_percentiles(_t(x), _t(valid), qs).numpy()
    ref = np.asarray(jselectq.masked_percentiles(jnp.asarray(x), jnp.asarray(valid), qs))
    np.testing.assert_array_equal(got, ref)
    for r in (0, 1, 3):
        sel = x[r][valid[r] & np.isfinite(x[r])]
        np.testing.assert_allclose(got[r], np.percentile(sel, qs), rtol=1e-6)
    assert np.all(np.isnan(got[2]))


# --------------------------------------------------------------- fftmask ----


@pytest.mark.parametrize("channels", [2, 1])
@pytest.mark.parametrize("band_mode", ["three", "third"])
def test_apply_band_masks_matches_jax(channels, band_mode):
    n = 1 << 15
    x = _decaying_noise((2, channels), n, 6)
    jc = dataclasses.replace(JaxEngineConfig(), band_mode=band_mode)
    masks = jbatch._band_masks(jc, n)
    got = fftmask.apply_band_masks(_t(x), _t(masks)).numpy()
    ref = np.asarray(jfftmask.apply_band_masks(jnp.asarray(x), jnp.asarray(masks)))
    assert got.shape == ref.shape == (2, channels, masks.shape[0], n)
    assert np.max(np.abs(got - ref)) <= 1e-6 * np.max(np.abs(x))


def test_band_definitions_match_jax():
    for ours, theirs in (
        (fftmask.build_three_band_definitions(SR), jfftmask.build_three_band_definitions(SR)),
        (
            fftmask.build_fractional_octave_band_definitions(SR, 3),
            jfftmask.build_fractional_octave_band_definitions(SR, 3),
        ),
    ):
        assert [dataclasses.astuple(b) for b in ours] == [dataclasses.astuple(b) for b in theirs]


# ------------------------------------------------------------- diffusion ----


@pytest.mark.parametrize("channels", [1, 2])
def test_diffusion_metrics_match_jax(channels):
    n = 1 << 15
    x = _decaying_noise((2, channels), n, 8)
    lengths = np.full((2, channels), n, np.int32)
    lengths[1] = 20000
    x[1, :, 20000:] = 0.0
    win, hop, max_lag = 2400, 2400, 240
    got = diffusion.diffusion_metrics(_t(x), _t(lengths), win, hop, max_lag, SR)
    ref = jdiffusion.diffusion_metrics(
        jnp.asarray(x), jnp.asarray(lengths), win, hop, max_lag, SR, 1.0, True, "xla"
    )
    np.testing.assert_array_equal(got.num_frames.numpy(), np.asarray(ref.num_frames))
    for name in ("time_seconds", "max_abs_autocorr", "echo_density"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)), atol=1e-5, equal_nan=True
        )
    if channels == 2:
        st = diffusion.stereo_diffusion_metrics(
            _t(x[:, 0]), _t(x[:, 1]), _t(lengths[:, 0]), win, hop, max_lag
        )
        st_ref = jdiffusion.stereo_diffusion_metrics(
            jnp.asarray(x[:, 0]), jnp.asarray(x[:, 1]), jnp.asarray(lengths[:, 0]),
            win, hop, max_lag, "xla",
        )
        for name in ("corr0", "iacc_max"):
            np.testing.assert_allclose(
                getattr(st, name).numpy(), np.asarray(getattr(st_ref, name)),
                atol=1e-5, equal_nan=True,
            )


@pytest.mark.parametrize("helper", ["valid_mask", "bool_valid_mask", "db_from_magnitude", "db_from_power", "next_pow2"])
def test_common_helpers_match_jax(helper):
    from audio_analysis_tpu.ops import common as jcommon

    lengths = np.array([[0, 5], [17, 64]], np.int32)
    mag = np.abs(np.random.default_rng(1).standard_normal((3, 50))).astype(np.float32) * 1e-4
    mag[0, :5] = 0.0
    if helper in ("valid_mask", "bool_valid_mask"):
        got = getattr(common, helper)(64, _t(lengths)).numpy()
        ref = np.asarray(getattr(jcommon, helper)(64, jnp.asarray(lengths)))
    elif helper == "db_from_magnitude":
        got = common.db_from_magnitude(_t(mag), -80.0).numpy()
        ref = np.asarray(jcommon.db_from_magnitude(jnp.asarray(mag), -80.0))
    elif helper == "db_from_power":
        got = common.db_from_power(_t(mag), 1e-10).numpy()
        ref = np.asarray(jcommon.db_from_power(jnp.asarray(mag), 1e-10))
    else:
        got = np.array([common.next_pow2(v) for v in (0, 1, 2, 3, 2641, 4096, 4097)])
        ref = np.array([jcommon.next_pow2(v) for v in (0, 1, 2, 3, 2641, 4096, 4097)])
    assert got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_unwrap_nanmax_nanmedian_follow_numpy():
    rng = np.random.default_rng(9)
    p = (np.cumsum(rng.standard_normal((3, 500)) * 2.5, axis=-1) % (2 * np.pi) - np.pi).astype(np.float32)
    p[0, 10] = p[0, 9] + np.float32(np.pi)  # an exact +pi step
    np.testing.assert_allclose(common.unwrap(_t(p)).numpy(), np.unwrap(p), atol=1e-4)
    np.testing.assert_allclose(
        common.unwrap(_t(p)).numpy(), np.asarray(jnp.unwrap(jnp.asarray(p))), atol=1e-4
    )
    x = np.array([[1.0, np.nan, 3.0, 2.0], [np.nan] * 4, [4.0, 1.0, 2.0, 3.0]], np.float32)
    np.testing.assert_array_equal(common.nanmax(_t(x)).numpy(), np.asarray(jnp.nanmax(x, axis=-1)))
    np.testing.assert_allclose(
        common.nanmedian(_t(x)).numpy(), np.asarray(jnp.nanmedian(x, axis=-1)), equal_nan=True
    )
    assert common.nanmedian(_t(x)).numpy()[2] == 2.5  # mean of the two middle values
