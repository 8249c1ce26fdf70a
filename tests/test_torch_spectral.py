"""Op-level parity of what the port's per-file analyses reach, against the
JAX package on its CPU backend, on the same seeded inputs.

Tolerances, each with its reason:
- box_smooth_same and the smoothed EDC: the port accumulates the running
  sum in float64, the JAX package in float32, so the JAX side carries up
  to ulp(max |running sum|) / w of rounding per output. The port is held
  to np.convolve in float64 within 1e-4 dB, and to the JAX package within
  4 ulp(max |running sum|) / w. Unsmoothed EDC: 1e-4 dB (two float32
  reversed cumulative sums).
- stft_mag_db: 0.01 dB within 80 dB of the plane's peak (float32 FFTs of
  different factorisations), the same frame counts and floor cells.
- segment_spectrum: dB within 1e-3 above -100 dB, the same peak bin,
  centroid 1e-5 relative. group_delay: on a delayed impulse (a linear
  phase, well conditioned) within 0.05 samples (the float32 ulp of the
  unwrapped phase, about 2e-4 rad at 700 samples of delay, over the bin
  spacing of 4e-4 rad, averaged by the median); the percentiles of a
  decaying-noise IR (ill-conditioned in float32) within 2e-2 relative or
  5 samples, the reference-parity tolerance.
- deconvolve_spectral: within 1e-5 of the peak (float32 FFTs).
- ar_normal_equations: the float32 Gram within 1e-6 relative Frobenius of
  a float64 Gram built by index gather (tests/_ar_reference.py), the
  moment within 1e-5 (a sum with cancellation); the JAX package's float32
  Gram is held to the same bounds. The host solve, poles and FIR zeros
  are the JAX package's numpy code: identical on identical input.
- quantize_db_i16: exact int16, half-way values included.
- the WAV helpers: byte-identical arrays, headers and files;
  results_to_json: the identical text.
"""

import dataclasses
from pathlib import Path

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from audio_analysis_tpu.io import wav as jwav  # noqa: E402
from audio_analysis_tpu.ops import common as jcommon  # noqa: E402
from audio_analysis_tpu.ops import diffusion as jdiffusion  # noqa: E402
from audio_analysis_tpu.ops import display as jdisplay  # noqa: E402
from audio_analysis_tpu.ops import edc as jedc  # noqa: E402
from audio_analysis_tpu.ops import logfreq as jlogfreq  # noqa: E402
from audio_analysis_tpu.ops import spectral as jspectral  # noqa: E402
from audio_analysis_tpu.ops import stft as jstft  # noqa: E402
from audio_analysis_tpu.ops import trim as jtrim  # noqa: E402
from audio_analysis_tpu.utils import jsonio as jjsonio  # noqa: E402
from _ar_reference import ar_normal_equations_f64, relative_frobenius  # noqa: E402
from audio_analysis_tpu_torch.io import wav  # noqa: E402
from audio_analysis_tpu_torch.ops import common, diffusion, display, edc, logfreq, spectral, stft  # noqa: E402
from audio_analysis_tpu_torch.utils import jsonio  # noqa: E402

torch.set_num_threads(2)
SR = 48_000
F32_EPS = float(np.finfo(np.float32).eps)


def _cpu():
    return jax.default_device(jax.devices("cpu")[0])


def _decay(rows, n, seed, tau=8000.0):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((rows, n)) * np.exp(-np.arange(n) / tau)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("window", [2, 7, 8, 480])
def test_box_smooth_same_matches_convolve_and_jax(window):
    rng = np.random.default_rng(window)
    x = (-60.0 + 10.0 * rng.standard_normal((2, 1 << 15))).astype(np.float32)
    got = common.box_smooth_same(_t(x), window).numpy()
    ref = np.stack([np.convolve(r.astype(np.float64), np.ones(window) / window, mode="same") for r in x])
    with _cpu():
        theirs = np.asarray(jcommon.box_smooth_same(jnp.asarray(x), window))
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    bound = 4.0 * F32_EPS * np.abs(np.cumsum(x, axis=-1)).max() / window
    assert np.abs(got - theirs).max() <= bound


@pytest.mark.parametrize("window", [0, 2, 7, 480])
def test_edc_smoothing_matches_jax(window):
    n = 1 << 15
    x = _decay(3, n, window)
    lengths = np.array([n, n - 3000, 4000], np.int32)
    x[1, n - 3000 :] = 0.0
    x[2, 4000:] = 0.0
    got = edc.schroeder_edc_db(_t(x), _t(lengths), smoothing_window_samples=window).edc_db.numpy()
    with _cpu():
        theirs = np.asarray(
            jedc.schroeder_edc_db(jnp.asarray(x), jnp.asarray(lengths), smoothing_window_samples=window).edc_db
        )
    past = np.arange(n)[None, :] >= lengths[:, None]
    assert (got[past] == 0).all() and (got >= -120.0).all()
    if window <= 1:
        np.testing.assert_allclose(got, theirs, rtol=0, atol=1e-4)
        return
    # the port against np.convolve of its own unfloored curve in float64,
    # then the floor; and against the JAX package's float32 running sum
    raw = edc.schroeder_edc_db_plain(_t(x), _t(lengths), edc_floor_db=-np.inf).numpy().astype(np.float64)
    ref = np.stack([np.convolve(r, np.ones(window) / window, mode="same") for r in np.where(past, 0.0, raw)])
    ref = np.where(past, 0.0, np.maximum(ref, -120.0))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    bound = 4.0 * F32_EPS * np.abs(np.cumsum(np.where(past, 0.0, raw), axis=-1)).max() / window
    assert np.abs(got - theirs).max() <= bound


@pytest.mark.parametrize("n_fft,hop", [(4096, 512), (8192, 512), (3000, 512), (32768, 512)])
def test_stft_mag_db_matches_jax(n_fft, hop):
    n = 1 << 16
    x = _decay(2, n, n_fft, tau=20000.0)
    lengths = np.array([n, n - 5000], np.int32)
    x[1, n - 5000 :] = 0.0
    got = stft.stft_mag_db(_t(x), _t(lengths), n_fft, hop)
    with _cpu():
        # the matmul FFT of the JAX package's per-file path (jnp.fft where
        # n_fft is not a power of two)
        theirs = jstft.stft_mag_db(jnp.asarray(x), jnp.asarray(lengths), n_fft, hop, True, -120.0, "mx")
    a, b = got.mag_db.numpy(), np.asarray(theirs.mag_db)
    assert a.shape == b.shape == (2, stft.num_frames_static(n, n_fft, hop), n_fft // 2 + 1)
    np.testing.assert_array_equal(got.num_frames.numpy(), np.asarray(theirs.num_frames))
    loud = b > b.max() - 80.0
    assert np.abs(a - b)[loud].max() <= 0.01
    invalid = np.arange(a.shape[1])[None, :] >= got.num_frames.numpy()[:, None]
    assert (a[invalid] == -120.0).all() and (b[invalid] == -120.0).all()
    assert stft.STFT_KERNEL.launches == 0


@pytest.mark.parametrize("use_hann_window", [True, False])
def test_segment_spectrum_matches_jax(use_hann_window):
    n = 1 << 15
    x = _decay(2, n, 3)
    lengths = np.array([n, 20000], np.int32)
    x[1, 20000:] = 0.0
    got = spectral.segment_spectrum(_t(x), _t(lengths), SR, use_hann_window, -120.0, 50.0, 15000.0, True)
    with _cpu():
        theirs = jspectral.segment_spectrum(
            jnp.asarray(x), jnp.asarray(lengths), SR, use_hann_window, -120.0, 50.0, 15000.0, True
        )
    a, b = got.mag_db.numpy(), np.asarray(theirs.mag_db)
    assert np.abs(a - b)[b > -100.0].max() <= 1e-3
    np.testing.assert_array_equal(got.peak_frequency_hz.numpy(), np.asarray(theirs.peak_frequency_hz))
    np.testing.assert_allclose(got.spectral_centroid_hz.numpy(), np.asarray(theirs.spectral_centroid_hz), rtol=1e-5)
    np.testing.assert_allclose(got.magnitude_at_1khz_db.numpy(), np.asarray(theirs.magnitude_at_1khz_db), atol=1e-3)


@pytest.mark.parametrize("smoothing_bins", [0, 33])
def test_group_delay_matches_jax(smoothing_bins):
    n, delay = 1 << 14, 700
    impulse = np.zeros((1, n), np.float32)
    impulse[0, delay] = 1.0
    noise = _decay(2, n, 9, tau=3000.0)
    for x, tol in ((impulse, (0.0, 0.05)), (noise, (2e-2, 5.0))):
        lengths = np.full((x.shape[0],), n, np.int32)
        got = spectral.group_delay(_t(x), _t(lengths), SR, False, True, smoothing_bins)
        with _cpu():
            theirs = jspectral.group_delay(jnp.asarray(x), jnp.asarray(lengths), SR, False, True, smoothing_bins)
        for name in ("median", "p10", "p90"):
            a, b = getattr(got, name).numpy(), np.asarray(getattr(theirs, name))
            assert np.all(np.abs(a - b) <= np.maximum(tol[1], tol[0] * np.abs(b))), name
    # a pure delay: the group delay is the delay in every bin
    np.testing.assert_allclose(
        spectral.group_delay(_t(impulse), _t(np.array([n], np.int32)), SR, False).median.numpy(), [delay], atol=0.05
    )


@pytest.mark.parametrize("regularization", [1e-10, 1e-6])
def test_deconvolve_spectral_matches_jax(regularization):
    rng = np.random.default_rng(4)
    sweep = rng.standard_normal(5000).astype(np.float32)
    recorded = rng.standard_normal((1, 2, 7000)).astype(np.float32)
    got = spectral.deconvolve_spectral(_t(recorded), _t(sweep), 8192, regularization).numpy()
    with _cpu():
        theirs = np.asarray(jspectral.deconvolve_spectral(jnp.asarray(recorded), jnp.asarray(sweep), 8192, regularization))
    assert got.shape == theirs.shape == (1, 2, 8192)
    assert np.abs(got - theirs).max() <= 1e-5 * np.abs(theirs).max()


# (N, order, chunk, valid lengths): one chunk, chunk edges with masked
# rows, several chunks, a row count not a multiple of the chunk
@pytest.mark.parametrize(
    "n,order,chunk,lengths",
    [(8192, 16, 65536, (8192, 5000)), (4096, 32, 1000, (4096, 3000)), (1 << 16, 64, 65536, (1 << 16, 40000)),
     (20000, 7, 999, (19999, 123))],
)
def test_ar_normal_equations_match_float64_and_jax(n, order, chunk, lengths):
    rng = np.random.default_rng(n + order)
    t = np.arange(n) / 48_000
    x = (rng.standard_normal((2, n)) * np.exp(-t / 0.3)).astype(np.float32)
    lens = np.array(lengths, np.int32)
    for i, length in enumerate(lens):
        x[i, length:] = 0.0
    got = spectral.ar_normal_equations(torch.from_numpy(x), torch.from_numpy(lens), order, chunk=chunk)
    theirs = jspectral.ar_normal_equations(jnp.asarray(x), jnp.asarray(lens), order, chunk=chunk)
    gram, moment = ar_normal_equations_f64(torch.from_numpy(x), torch.from_numpy(lens), order)
    assert got.gram.dtype == torch.float32 and got.gram.shape == (2, order, order)
    assert got.moment.shape == (2, order)
    for g, m in ((got.gram, got.moment), (torch.from_numpy(np.asarray(theirs.gram)),
                                          torch.from_numpy(np.asarray(theirs.moment)))):
        assert relative_frobenius(g, gram) <= 1e-6
        assert relative_frobenius(m[:, None, :], moment[:, None, :]) <= 1e-5


def test_ar_solve_poles_and_zeros_match_jax():
    rng = np.random.default_rng(2)
    x = np.zeros((1, 4096), np.float32)
    x[0, :3000] = rng.standard_normal(3000) * np.exp(-np.arange(3000) / 400.0)
    normal = jspectral.ar_normal_equations(jnp.asarray(x), jnp.asarray(np.array([3000], np.int32)), 24)
    gram, moment = np.asarray(normal.gram)[0], np.asarray(normal.moment)[0]
    for ridge in (0.0, 1e-5):
        a = spectral.solve_ar_coefficients(gram, moment, ridge)
        assert np.array_equal(a, jspectral.solve_ar_coefficients(gram, moment, ridge))
        assert np.array_equal(spectral.ar_poles(a), jspectral.ar_poles(a))
        b = spectral.derive_fir_numerator_from_ar(a, x[0, :3000].astype(np.float64), 16)
        assert np.array_equal(b, jspectral.derive_fir_numerator_from_ar(a, x[0, :3000].astype(np.float64), 16))
    assert spectral.ar_poles(np.array([1.0, 0.0, 1e-15])).size == 0


def test_quantize_db_i16_is_exact_against_jax():
    halves = (np.arange(-40, 40, dtype=np.float32) + 0.5) / np.float32(128.0)
    rng = np.random.default_rng(1)
    x = np.concatenate([
        halves, -halves, np.array([0.0, 255.99, -255.99, 300.0, -300.0, -120.0, 1e-3, 0.5], np.float32),
        (rng.standard_normal(4096) * 100.0).astype(np.float32),
    ]).reshape(2, -1)
    got = display.quantize_db_i16(_t(x))
    with _cpu():
        theirs = np.asarray(jdisplay.quantize_db_i16(jnp.asarray(x)))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), theirs)
    np.testing.assert_array_equal(display.dequantize_db_i16(got.numpy()), jdisplay.dequantize_db_i16(theirs))


def test_frame_slices_and_frequency_selection_match_jax():
    plane = (-60.0 + 20.0 * np.random.default_rng(2).standard_normal((2, 40, 2049))).astype(np.float32)
    idx = np.array([[0, 3, 17, 39], [1, 1, 20, 20]], np.int32)
    assert display.freq_selection(4096, SR, 20.0, 20000.0) == jdisplay.freq_selection(4096, SR, 20.0, 20000.0)
    got = display.stft_frame_slices(_t(plane), idx, 4096, SR, 20.0, 20000.0)
    with _cpu():
        theirs = jdisplay.stft_frame_slices(jnp.asarray(plane), idx, 4096, SR, 20.0, 20000.0)
    np.testing.assert_array_equal(got, theirs)


@pytest.mark.parametrize("smoothing_log_bins", [0, 5, 9])
def test_log_frequency_smoothing_matches_jax(smoothing_log_bins):
    freqs = np.fft.rfftfreq(8192, 1.0 / SR).astype(np.float32)
    mag = (-40.0 + 6.0 * np.random.default_rng(smoothing_log_bins).standard_normal((3, freqs.size))).astype(np.float32)
    got = logfreq.smooth_mag_db_log_frequency(freqs, _t(mag), 30.0, 15000.0, smoothing_log_bins, 48).numpy()
    with _cpu():
        theirs = np.asarray(
            jlogfreq.smooth_mag_db_log_frequency(freqs, jnp.asarray(mag), 30.0, 15000.0, smoothing_log_bins, 48)
        )
    sel, grid = logfreq.log_grid_for_range(freqs, 30.0, 15000.0, 48)
    # the JAX side's float32 running sum over the grid (see the top)
    bound = 4.0 * F32_EPS * grid.size * np.abs(mag).max() / max(smoothing_log_bins, 1)
    np.testing.assert_allclose(got, theirs, rtol=0, atol=max(bound, 1e-5))
    ref_sel, ref_grid = jlogfreq.log_grid_for_range(freqs, 30.0, 15000.0, 48)
    np.testing.assert_array_equal(sel, ref_sel)
    np.testing.assert_array_equal(grid, ref_grid)


def test_log_bin_aggregation_matches_jax():
    freqs = np.fft.rfftfreq(4096, 1.0 / SR)
    centres, matrix, _ = logfreq.build_log_bin_matrix(freqs, logfreq.build_log_bin_edges(20.0, 20000.0, 24, 24))
    plane = (-70.0 + 15.0 * np.random.default_rng(3).standard_normal((2, 30, freqs.size))).astype(np.float32)
    got = logfreq.aggregate_db_to_log_bins(_t(plane), _t(matrix)).numpy()
    with _cpu():
        theirs = np.asarray(jlogfreq.aggregate_db_to_log_bins(jnp.asarray(plane), jnp.asarray(matrix)))
    assert got.shape == theirs.shape == (2, centres.size, 30)
    np.testing.assert_allclose(got, theirs, rtol=0, atol=1e-4)


def test_shift_bands_to_matches_jax():
    """The port aligns a (channels, bands, N) plane inside the EDC, reading
    each band row from its channel's start (rt60bands and the engine's
    bands block); the JAX package shifts the plane with shift_bands_to and
    then takes the EDC. Same aligned lengths, curves within the unsmoothed
    EDC tolerance."""
    x = _decay(9, 5000, 5).reshape(3, 3, 5000)
    start, length = np.array([100, 4999, 1443], np.int32), np.array([5000, 5000, 4100], np.int32)
    x[2, :, 4100:] = 0.0
    plane = x.shape[:-1]
    got = edc.schroeder_edc_db(
        _t(x), _t(length)[:, None].expand(plane), start=_t(start)[:, None].expand(plane)
    )
    with _cpu():
        aligned = jtrim.shift_bands_to(jnp.asarray(x), jnp.asarray(start), jnp.asarray(length))
        theirs = jedc.schroeder_edc_db(aligned.samples, aligned.length)
    np.testing.assert_array_equal(got.length.numpy(), np.asarray(theirs.length))
    assert got.length.numpy()[1].tolist() == [1, 1, 1]
    np.testing.assert_allclose(got.edc_db.numpy(), np.asarray(theirs.edc_db), rtol=0, atol=1e-4)


def test_stereo_diffusion_rows_and_frame_times_match_jax():
    x = _decay(2, 20000, 6, tau=5000.0)
    lengths = np.array([18000, 18000], np.int32)
    got = diffusion.stereo_diffusion_metrics_rows(_t(x), _t(lengths), 2400, 480, 240)
    with _cpu():
        theirs = jdiffusion.stereo_diffusion_metrics_rows(jnp.asarray(x), jnp.asarray(lengths), 2400, 480, 240)
    for a, b in zip(got, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        diffusion.diffusion_frame_times(20000, 2400, 480, SR), jdiffusion.diffusion_frame_times(20000, 2400, 480, SR)
    )


# ------------------------------------------------------------- I/O ----


@pytest.fixture(scope="module")
def wav_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavio")
    rng = np.random.default_rng(8)
    stereo = (0.3 * rng.standard_normal((3001, 2))).astype(np.float32)
    files = {
        "stereo16": (stereo * 32767).astype(np.int16),
        "mono16": (stereo[:, 0] * 32767).astype(np.int16),
        "stereo_f32": stereo,
        "quad16": (0.3 * rng.standard_normal((100, 4)) * 32767).astype(np.int16),
    }
    paths = {}
    for name, data in files.items():
        paths[name] = root / f"{name}.wav"
        wavfile.write(str(paths[name]), SR, data)
    paths["rate44"] = root / "rate44.wav"
    wavfile.write(str(paths["rate44"]), 44_100, files["mono16"])
    return paths


@pytest.mark.parametrize("name", ["stereo16", "mono16", "stereo_f32", "quad16", "rate44"])
@pytest.mark.parametrize(
    "mode,upmix", [("stereo", True), ("stereo", False), ("mono", True), ("mono_or_stereo", False)]
)
def test_load_wav_file_channel_modes_match_jax(wav_files, name, mode, upmix):
    path = wav_files[name]
    outcome = []
    for module in (wav, jwav):
        try:
            loaded = module.load_wav_file(path, expected_channel_mode=mode, allow_mono_and_upmix_to_stereo=upmix)
        except ValueError as exc:
            outcome.append(("error", str(exc)))
            continue
        channels = module.get_analysis_channels(loaded, False) + module.get_analysis_channels(loaded, True)
        outcome.append((loaded.samples.tobytes(), loaded.sample_rate_hz, [(n, c.tobytes()) for n, c in channels],
                        module.downmix_to_mono(loaded.samples).tobytes(),
                        module.get_channel(loaded, 0).tobytes()))
    assert outcome[0] == outcome[1]
    assert wav.read_wav_header_info(path) == jwav.read_wav_header_info(path)


def test_left_right_and_float32_writer_match_jax(wav_files, tmp_path):
    stereo = wav.load_wav_file(wav_files["stereo16"])
    for a, b in zip(wav.get_left_right(stereo), jwav.get_left_right(jwav.load_wav_file(wav_files["stereo16"]))):
        assert a.tobytes() == b.tobytes()
    mono = wav.load_wav_file(wav_files["mono16"], expected_channel_mode="mono")
    with pytest.raises(ValueError) as ours:
        wav.get_left_right(mono)
    with pytest.raises(ValueError) as theirs:
        jwav.get_left_right(jwav.load_wav_file(wav_files["mono16"], expected_channel_mode="mono"))
    assert str(ours.value) == str(theirs.value)
    samples = np.random.default_rng(0).standard_normal((777, 2)).astype(np.float32)
    wav.write_wav_float32(tmp_path / "a" / "ours.wav", samples, SR)
    jwav.write_wav_float32(tmp_path / "b" / "theirs.wav", samples, SR)
    assert (tmp_path / "a" / "ours.wav").read_bytes() == (tmp_path / "b" / "theirs.wav").read_bytes()


@dataclasses.dataclass(frozen=True)
class _Inner:
    name: str
    values: np.ndarray


@dataclasses.dataclass(frozen=True)
class _Outer:
    path: Path
    fits: dict
    items: list
    big: np.ndarray
    spectrum: np.ndarray
    nothing: object = None


def test_results_json_matches_jax(tmp_path):
    big = np.linspace(-1.0, 1.0, 9000, dtype=np.float32)
    big[5] = np.nan
    tree = [
        _Outer(
            path=Path("/x/y.wav"),
            fits={"T30": _Inner("T30", np.array([1.5, np.nan, np.inf], np.float32)), 3: np.float32(2.5)},
            items=[np.int64(3), np.bool_(True), (1.0, float("nan"))],
            big=big,
            spectrum=np.array([1 + 2j, 3 - 4j], np.complex64),
        ),
        np.zeros((100, 100), np.float32),
        np.array([np.nan] * 9000),
    ]
    assert jsonio.results_to_json(tree) == jjsonio.results_to_json(tree)
    assert jsonio.results_to_json(tree, full_arrays=True) == jjsonio.results_to_json(tree, full_arrays=True)
    path = jsonio.write_results_json(tmp_path / "sub" / "r.json", tree)
    assert path.read_text() == jjsonio.results_to_json(tree) + "\n"
