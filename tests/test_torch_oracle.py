"""The port's float64 oracle (audio_analysis_tpu_torch/oracle) and the
port's ops against it, on the CPU.

- The copy is faithful: every public function of the JAX package's oracle
  and of the port's copy gives bit-equal outputs (np.array_equal, the same
  None / tuple structure) on seeded numpy inputs, and the copy imports
  numpy only.
- The port's ops (the plain torch versions the CPU runs) against the
  port's oracle: the counterparts of tests/test_ops_vs_oracle.py,
  tests/test_plotmath_vs_oracle.py and tests/test_edc_precision.py, with
  those tests' tolerances. `test_segment_spectrum_matches_oracle_full_length`
  holds the unwrapped phase at 2e-3 rad as the JAX test does.
"""

import ast
import inspect
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_analysis_tpu import oracle as jax_oracle
from audio_analysis_tpu_torch import oracle
from audio_analysis_tpu_torch.analyses.spectrogram import (
    SpectrogramAnalysisSettings,
    SpectrogramPlotSettings,
    analyse_spectrogram_for_channel,
    spectrogram_color_limits,
)
from audio_analysis_tpu_torch.analyses.waterfall import WaterfallAnalysisSettings, analyse_waterfall_for_channel
from audio_analysis_tpu_torch.ops import dbfit, diffusion, edc, fftmask, logfreq, spectral, stft, trim
from audio_analysis_tpu_torch.report.waterfall import select_slice_frame_indices
from audio_analysis_tpu_torch.signals import generate_log_sine_sweep

torch.set_num_threads(2)

SR = 48_000


def _public(module) -> list:
    return sorted(
        name for name, fn in vars(module).items()
        if inspect.isfunction(fn) and fn.__module__ == module.__name__ and not name.startswith("_")
    )


# ----------------------------------------------------------------------------
# the copy is faithful
# ----------------------------------------------------------------------------


def _decay(seed, n=4096, tau=600.0, onset=40):
    rng = np.random.default_rng(seed)
    x = np.zeros(n)
    x[onset:] = rng.standard_normal(n - onset) * np.exp(-np.arange(n - onset) / tau)
    x[onset] = 3.0
    return x


def _edc_curve(seed):
    return oracle.schroeder_edc_db(_decay(seed), SR)[:2]


def _freqs():
    return np.fft.rfftfreq(2048, 1.0 / SR)


# function -> argument tuples (each a call; the edges that return None or
# raise are among them)
CALLS = {
    "schroeder_edc_db": lambda: [
        (_decay(1), SR),
        (_decay(2).astype(np.float32), SR, False, 0.002, 1e-12, -90.0, 33),
        (_decay(3), SR, True, 0.0, 1e-20, -np.inf, 0),
        (np.zeros(3), SR),
    ],
    "crossing_time": lambda: [
        (*_edc_curve(4), target) for target in (0.0, -5.0, -35.0, -400.0)
    ] + [(np.arange(4.0), np.array([0.0, -1.0, -1.0, -3.0]), -1.0)],
    "fit_decay_slope": lambda: [
        (*_edc_curve(5), rng_db, floor, pts)
        for rng_db, floor, pts in (((-5.0, -35.0), -80.0, 8), ((0.0, -10.0), -80.0, 8),
                                   ((-5.0, -95.0), -30.0, 8), ((-5.0, -25.0), -80.0, 10 ** 6))
    ] + [(np.arange(64.0), np.linspace(-40.0, 0.0, 64), (-5.0, -25.0))],
    "stft_magnitude_db": lambda: [
        (_decay(6), SR, 512, 128),
        (_decay(7), SR, 300, 77, False, -90.0),
        (_decay(8)[:100], SR, 256, 64),
    ],
    "waterfall_rel_db_slices": lambda: [
        (np.random.default_rng(9).standard_normal((6, 40)) * 20, mode, dyn)
        for mode, dyn in (("global_max", 60.0), ("slice_max", 5.0), ("SLICE_MAX", 90.0))
    ],
    "spectrogram_color_scale": lambda: [
        (np.random.default_rng(10).standard_normal((50, 30)) * 20, dyn) for dyn in (90.0, None, 40.0)
    ],
    "raised_cosine_ramp": lambda: [(_freqs(), 100.0, 400.0), (_freqs(), 400.0, 100.0), (_freqs(), 5.0, 5.0)],
    "lowpass_mask": lambda: [(_freqs(), 250.0, 1 / 6, SR / 2), (_freqs(), 23990.0, 1.0, SR / 2),
                             (_freqs(), 0.5, 0.0, SR / 2)],
    "highpass_mask": lambda: [(_freqs(), 4000.0, 1 / 6, SR / 2), (_freqs(), 1.5, 1.0, SR / 2),
                              (_freqs(), 300.0, 0.0, SR / 2)],
    "bandpass_mask": lambda: [(_freqs(), 500.0, 2000.0, 1 / 6, SR / 2), (_freqs(), 2000.0, 500.0, 0.5, SR / 2),
                              (_freqs(), 20.0, 30000.0, 1.0, SR / 2)],
    "apply_fft_mask": lambda: [
        (_decay(11, 2048), oracle.bandpass_mask(np.fft.rfftfreq(2048, 1 / SR), 300.0, 3000.0, 1 / 3, SR / 2)),
        (_decay(12, 2047).astype(np.float32), np.linspace(0.0, 1.0, 1024)),
    ],
    "deconvolve": lambda: [
        (np.random.default_rng(13).standard_normal((3000, 2)), np.random.default_rng(14).standard_normal(2500)),
        (np.random.default_rng(15).standard_normal((1000, 1)), np.random.default_rng(16).standard_normal(1500), 1e-6),
    ],
    "windowed_max_abs_autocorr": lambda: [
        (_decay(17, 2400, 9000.0, 0), 240), (_decay(18, 100, 50.0, 0), 400), (np.ones(3), 2), (np.ones(64), 8),
    ],
    "windowed_echo_density": lambda: [
        (_decay(19, 2400, 9000.0, 0), thr, norm) for thr, norm in ((1.0, True), (1.5, False), (40.0, True))
    ] + [(np.zeros(10), 1.0, True), (np.ones(2), 1.0, True)],
    "windowed_corr0": lambda: [
        (_decay(20, 2400, 9000.0, 0), _decay(21, 2400, 9000.0, 0)), (np.ones(8), np.arange(8.0)),
        (np.ones(8), np.ones(9)), (np.arange(3.0), np.arange(3.0)),
    ],
    "windowed_iacc_max": lambda: [
        (_decay(22, 2400, 9000.0, 0), _decay(23, 2400, 9000.0, 0), 240), (np.arange(8.0), np.arange(8.0)[::-1], 30),
        (np.zeros(8), np.arange(8.0), 3),
    ],
    "fit_ar_least_squares": lambda: [
        (_decay(24, 3000, 300.0, 0), 8), (_decay(25, 3000, 300.0, 0), 12, 1e-3), (_decay(26, 5, 3.0, 0), 8),
        (_decay(27, 50, 30.0, 0), 0),
    ],
}


def _same(a, b) -> bool:
    """Bit-equal values with the same structure."""
    if isinstance(a, tuple) or isinstance(b, tuple):
        return type(a) is type(b) and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is b
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (
            isinstance(a, np.ndarray) and isinstance(b, np.ndarray) and a.dtype == b.dtype
            and np.array_equal(a, b, equal_nan=True)
        )
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return type(a) is type(b) and a == b


def _call(fn, args):
    try:
        return fn(*args)
    except ValueError as exc:
        return ("raised", str(exc))


def test_copy_has_every_function_of_the_jax_oracle():
    assert _public(oracle) == _public(jax_oracle) == sorted(CALLS)
    for name in CALLS:
        assert inspect.signature(getattr(oracle, name)) == inspect.signature(getattr(jax_oracle, name)), name


@pytest.mark.parametrize("name", sorted(CALLS))
def test_copy_is_bit_equal_to_the_jax_oracle(name):
    for args in CALLS[name]():
        ours = _call(getattr(oracle, name), args)
        theirs = _call(getattr(jax_oracle, name), args)
        assert _same(ours, theirs), (name, args)


def test_copy_imports_numpy_only():
    tree = ast.parse(Path(oracle.__file__).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots == {"__future__", "math", "typing", "numpy"}


# ----------------------------------------------------------------------------
# the port's ops against the oracle (tests/test_ops_vs_oracle.py)
# ----------------------------------------------------------------------------


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _lengths(shape, n):
    return torch.full(shape, n, dtype=torch.int32)


def _aligned(x, trim_to_peak=True, ignore=0.0):
    return trim.align_for_analysis(_t(np.asarray(x, np.float32)), _lengths(x.shape[:-1], x.shape[-1]), SR,
                                   trim_to_peak, ignore)


def test_align_matches_slicing(synthetic_ir):
    ir, sr, _, onset = synthetic_ir
    x = ir[0]
    a = _aligned(x[None, :])
    start = int(a.start_index[0])
    assert start == int(np.argmax(np.abs(x))) == onset
    seg = a.samples[0].numpy()
    expected = x[start:]
    np.testing.assert_allclose(seg[: expected.size], expected, atol=0)
    assert int(a.length[0]) == expected.size
    assert np.all(seg[expected.size:] == 0.0)


def test_align_ignore_and_duration():
    x = np.zeros(1000, np.float32)
    x[100] = 1.0
    x[101:] = 0.5
    a = trim.align_for_analysis(_t(x[None, :]), _lengths((1,), 1000), 1000, True, 0.05,
                                analysis_duration_seconds=0.2)
    assert int(a.start_index[0]) == 150
    assert int(a.length[0]) == 200


def test_edc_matches_oracle(synthetic_ir):
    ir, sr, _, _ = synthetic_ir
    x = ir[0]
    t_o, edc_o, start_o = oracle.schroeder_edc_db(x, sr)
    a = _aligned(x[None, :])
    r = edc.schroeder_edc_db(a.samples, a.length)
    got = r.edc_db[0].numpy()[: edc_o.size]
    assert int(a.start_index[0]) == start_o
    usable = edc_o > -90.0
    np.testing.assert_allclose(got[usable], edc_o[usable], atol=0.02)


def test_edc_smoothing_matches_convolve():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * np.exp(-np.arange(4096) / 800)).astype(np.float32)
    _, edc_o, _ = oracle.schroeder_edc_db(x, SR, trim_to_peak=False, smoothing_window_samples=33)
    a = _aligned(x[None, :], trim_to_peak=False)
    r = edc.schroeder_edc_db(a.samples, a.length, smoothing_window_samples=33)
    np.testing.assert_allclose(r.edc_db[0].numpy(), edc_o, atol=0.05)


def test_crossing_matches_oracle(synthetic_ir):
    ir, sr, _, _ = synthetic_ir
    x = ir[1]
    t_o, edc_o, _ = oracle.schroeder_edc_db(x, sr)
    a = _aligned(x[None, :])
    r = edc.schroeder_edc_db(a.samples, a.length)
    for target in (0.0, -5.0, -10.0, -25.0, -35.0):
        c = dbfit.crossing_time(r.edc_db, r.length, target, sr)
        expected = oracle.crossing_time(t_o, edc_o, target)
        if expected is None:
            assert not bool(c.found[0])
        else:
            assert bool(c.found[0])
            assert abs(float(c.time_seconds[0]) - expected) < 2.0 / sr + 1e-5


def test_fit_matches_oracle_and_recovers_rt60(synthetic_ir):
    ir, sr, rt60_true, _ = synthetic_ir
    for ch in range(2):
        x = ir[ch]
        t_o, edc_o, _ = oracle.schroeder_edc_db(x, sr)
        a = _aligned(x[None, :])
        r = edc.schroeder_edc_db(a.samples, a.length)
        for rng_db in ((-5.0, -25.0), (-5.0, -35.0), (0.0, -10.0)):
            fit = dbfit.fit_decay_slope_over_db_range(r.edc_db, r.length, rng_db, -80.0, sr)
            expected = oracle.fit_decay_slope(t_o, edc_o, rng_db, -80.0)
            assert expected is not None and bool(fit.ok[0])
            slope_o, _intercept_o, r2_o, rt60_o = expected
            assert abs(float(fit.slope_db_per_second[0]) - slope_o) / abs(slope_o) < 2e-3
            assert abs(float(fit.rt60_seconds[0]) - rt60_o) / rt60_o < 2e-3
            assert abs(float(fit.r_squared[0]) - r2_o) < 5e-3
            assert abs(float(fit.rt60_seconds[0]) - rt60_true) / rt60_true < 0.05


def test_fit_rejects_rising_curve():
    n = 4096
    curve = _t(np.linspace(-40.0, 0.0, n, dtype=np.float32)[None, :])
    fit = dbfit.fit_decay_slope_over_db_range(curve, _lengths((1,), n), (-5.0, -25.0), -80.0, SR)
    assert not bool(fit.ok[0])
    assert oracle.fit_decay_slope(np.arange(n) / SR, curve[0].numpy().astype(np.float64), (-5.0, -25.0)) is None


def test_batched_fit_vectorises_over_bands():
    rt60s = np.array([[0.3, 0.6], [1.0, 1.5]])
    n = 1 << 17
    t = np.arange(n) / SR
    curves = -60.0 * t[None, None, :] / rt60s[..., None]
    fit = dbfit.fit_decay_slope_over_db_range(
        _t(curves.astype(np.float32)), _lengths((2, 2), n), (-5.0, -35.0), -80.0, SR
    )
    assert tuple(fit.rt60_seconds.shape) == (2, 2)
    np.testing.assert_allclose(fit.rt60_seconds.numpy(), rt60s, rtol=1e-3)
    assert bool(fit.ok.all())
    for i in range(2):
        for j in range(2):
            np.testing.assert_allclose(oracle.fit_decay_slope(t, curves[i, j], (-5.0, -35.0))[3], rt60s[i, j],
                                       rtol=1e-3)


def test_stft_matches_oracle():
    rng = np.random.default_rng(1)
    n, n_fft, hop = 16384, 1024, 256
    x = rng.standard_normal(n).astype(np.float32)
    t_o, f_o, mag_o = oracle.stft_magnitude_db(x, SR, n_fft, hop)
    r = stft.stft_mag_db(_t(x[None, :]), _lengths((1,), n), n_fft, hop)
    got = r.mag_db[0].numpy().T
    assert got.shape == mag_o.shape
    assert int(r.num_frames[0]) == mag_o.shape[1]
    np.testing.assert_allclose(got, mag_o, atol=5e-3)
    np.testing.assert_allclose(stft.frame_times_seconds(got.shape[1], hop, SR), t_o, atol=1e-6)
    np.testing.assert_allclose(stft.rfft_freqs_hz(n_fft, SR), f_o, atol=1e-3)


def test_stft_partial_validity():
    n, n_fft, hop = 8192, 1024, 256
    x = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    valid_len = 4096
    x[valid_len:] = 0.0
    r = stft.stft_mag_db(_t(x[None, :]), _lengths((1,), valid_len), n_fft, hop)
    expected_frames = 1 + (valid_len - n_fft) // hop
    assert int(r.num_frames[0]) == expected_frames
    got = r.mag_db[0].numpy()
    assert np.all(got[expected_frames:] == -120.0)
    _, _, mag_o = oracle.stft_magnitude_db(x[:valid_len], SR, n_fft, hop)
    assert mag_o.shape[1] == expected_frames
    np.testing.assert_allclose(got[:expected_frames].T, mag_o, atol=5e-3)


def test_masks_match_oracle():
    n = 16384
    freqs = np.fft.rfftfreq(n, 1.0 / SR)
    nyq = SR / 2
    np.testing.assert_allclose(fftmask.make_lowpass_mask(freqs, 250.0, 1 / 6, nyq),
                               oracle.lowpass_mask(freqs, 250.0, 1 / 6, nyq), atol=1e-12)
    np.testing.assert_allclose(fftmask.make_highpass_mask(freqs, 4000.0, 1 / 6, nyq),
                               oracle.highpass_mask(freqs, 4000.0, 1 / 6, nyq), atol=1e-12)
    np.testing.assert_allclose(fftmask.make_bandpass_mask(freqs, 500.0, 2000.0, 1 / 6, nyq),
                               oracle.bandpass_mask(freqs, 500.0, 2000.0, 1 / 6, nyq), atol=1e-12)


def test_batched_band_filtering_matches_oracle():
    n = 8192
    x = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    masks = fftmask.build_band_mask_matrix(fftmask.build_three_band_definitions(SR), n, SR, 1 / 6)
    out = fftmask.apply_band_masks(_t(x[None, :]), _t(masks)).numpy()[0]
    assert out.shape == (3, n)
    for b in range(3):
        np.testing.assert_allclose(out[b], oracle.apply_fft_mask(x, masks[b].astype(np.float64)), atol=2e-5)


def test_stereo_packed_band_filtering_matches_oracle():
    n = 8192
    x = np.random.default_rng(5).standard_normal((2, n)).astype(np.float32)
    masks = fftmask.build_band_mask_matrix(fftmask.build_three_band_definitions(SR), n, SR, 1 / 6)
    out = fftmask.apply_band_masks(_t(x), _t(masks)).numpy()
    assert out.shape == (2, 3, n)
    for c in range(2):
        for b in range(3):
            np.testing.assert_allclose(out[c, b], oracle.apply_fft_mask(x[c], masks[b].astype(np.float64)),
                                       atol=2e-5)


def test_fractional_octave_band_layout():
    bands = fftmask.build_fractional_octave_band_definitions(SR, 1)
    assert "1000Hz" in [b.name for b in bands]
    centres = [b.centre_hz for b in bands]
    np.testing.assert_allclose(np.diff(np.log2(centres)), 1.0, atol=1e-6)
    assert centres[0] >= 31.4 and centres[-1] <= 16000.1
    third = fftmask.build_fractional_octave_band_definitions(SR, 3)
    np.testing.assert_allclose(np.diff(np.log2([b.centre_hz for b in third])), 1.0 / 3.0, atol=1e-6)
    # each band's mask is the oracle's band-pass at its edges
    freqs = np.fft.rfftfreq(8192, 1.0 / SR)
    masks = fftmask.build_band_mask_matrix(third, 8192, SR, 1 / 6)
    for band, mask in zip(third, masks):
        np.testing.assert_allclose(mask, oracle.bandpass_mask(freqs, band.low_edge_hz, band.high_edge_hz, 1 / 6, SR / 2),
                                   atol=1e-6)


def test_segment_spectrum_diagnostics():
    n = 1 << 14
    f0 = 1000.0
    x = np.sin(2 * np.pi * f0 * np.arange(n) / SR).astype(np.float32)
    r = spectral.segment_spectrum(_t(x[None, :]), _lengths((1,), n), SR, use_hann_window=True)
    assert abs(float(r.peak_frequency_hz[0]) - f0) < SR / n + 1e-6
    assert abs(float(r.spectral_centroid_hz[0]) - f0) < 50.0


def test_segment_spectrum_matches_oracle_full_length():
    n = 4096
    x = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    r = spectral.segment_spectrum(_t(x[None, :]), _lengths((1,), n), SR)
    spec = np.fft.rfft(x.astype(np.float64) * np.hanning(n))
    expected_db = 20 * np.log10(np.maximum(np.abs(spec), 10 ** (-120 / 20)))
    np.testing.assert_allclose(r.mag_db[0].numpy(), expected_db, atol=2e-2)
    # the oracle's single full-length frame, unwindowed dB, agrees too
    _, _, mag_o = oracle.stft_magnitude_db(x, SR, n, n)
    np.testing.assert_allclose(r.mag_db[0].numpy(), mag_o[:, 0], atol=2e-2)
    np.testing.assert_allclose(r.phase[0].numpy(), np.unwrap(np.angle(spec)), atol=2e-3)


def test_group_delay_pure_delay():
    n = 4096
    delay = 100
    x = np.zeros(n, np.float32)
    x[delay] = 1.0
    r = spectral.group_delay(_t(x[None, :]), _lengths((1,), n), SR, use_hann_window=False,
                             f_min_hz=20.0, f_max_hz=20000.0)
    assert abs(float(r.median[0]) - delay) < 0.5
    assert abs(float(r.p90[0]) - delay) < 1.0


def test_deconvolve_matches_oracle():
    sweep = generate_log_sine_sweep(SR, 0.5, 2.0, 23999.0, post_silence_seconds=0.1).samples
    h_true = np.zeros(2000, np.float32)
    h_true[10] = 1.0
    h_true[500] = -0.3
    recorded = np.convolve(sweep, h_true)[: sweep.size].astype(np.float32)
    rec2 = recorded[:, None]
    expected = oracle.deconvolve(rec2, sweep)
    n_fft = 1 << int(max(rec2.shape[0], sweep.size) - 1).bit_length()
    got = spectral.deconvolve_spectral(_t(rec2.T[None, :, :]), _t(sweep), n_fft).numpy()[0, 0, : rec2.shape[0]]
    np.testing.assert_allclose(got, expected[:, 0], atol=5e-4)
    assert abs(got[10] - 1.0) < 0.02 and abs(got[500] + 0.3) < 0.02


def test_ar_normal_equations_match_oracle():
    rng = np.random.default_rng(6)
    n = 20000
    true_a = np.array([1.0, -1.2, 0.5])
    e = rng.standard_normal(n) * 0.01
    x = np.zeros(n)
    for i in range(2, n):
        x[i] = -true_a[1] * x[i - 1] - true_a[2] * x[i - 2] + e[i]
    x = x.astype(np.float32)
    p = 8
    r = spectral.ar_normal_equations(_t(x[None, :]), _lengths((1,), n), p, chunk=4096)
    a_got = spectral.solve_ar_coefficients(r.gram[0].numpy(), r.moment[0].numpy())
    a_oracle = oracle.fit_ar_least_squares(x, p)
    np.testing.assert_allclose(a_got[:3], a_oracle[:3], atol=2e-3)
    np.testing.assert_allclose(a_got[:3], true_a, atol=0.05)
    poles = spectral.ar_poles(a_got)
    assert 3 <= poles.size <= p
    assert np.max(np.abs(poles)) < 1.0


def test_ar_solve_is_stable_when_gram_is_ill_conditioned():
    sys.path.insert(0, str(Path(__file__).parent))
    import parity_matrix

    ir = parity_matrix.make_damped_ir()
    seg = ir[parity_matrix.DAMPED_ONSET :, 0].astype(np.float64)
    seg = (seg / np.max(np.abs(seg))).astype(np.float32)
    p = 16
    r = spectral.ar_normal_equations(_t(seg[None, :]), _lengths((1,), seg.size), p)
    gram, moment = r.gram[0].numpy(), r.moment[0].numpy()
    assert np.linalg.cond(gram.astype(np.float64)) > 1e6
    radii = np.abs(spectral.ar_poles(spectral.solve_ar_coefficients(gram, moment)))
    assert np.all(radii < 1.0), f"unstable poles from f32 Gram noise: {radii.max()}"
    radii64 = np.abs(spectral.ar_poles(oracle.fit_ar_least_squares(seg.astype(np.float64), p)))
    assert abs(radii.max() - radii64.max()) < 0.02
    assert abs(np.median(radii) - np.median(radii64)) < 0.05


def test_diffusion_metrics_match_oracle():
    rng = np.random.default_rng(7)
    n = 24000
    x = (rng.standard_normal(n) * np.exp(-np.arange(n) / 8000)).astype(np.float32)
    win, hop, max_lag = 2400, 480, 480
    r = diffusion.diffusion_metrics(_t(x[None, :]), _lengths((1,), n), win, hop, max_lag, SR)
    t_frames = 1 + (n - win) // hop
    assert int(r.num_frames[0]) == t_frames
    for i in (0, t_frames // 2, t_frames - 1):
        w = x[i * hop : i * hop + win]
        assert abs(float(r.max_abs_autocorr[0, i]) - oracle.windowed_max_abs_autocorr(w, max_lag)) < 1e-3
        assert abs(float(r.echo_density[0, i]) - oracle.windowed_echo_density(w, 1.0, True)) < 1e-3


def test_stereo_diffusion_matches_oracle():
    rng = np.random.default_rng(8)
    n = 12000
    shared = rng.standard_normal(n)
    left = (shared + 0.5 * rng.standard_normal(n)).astype(np.float32)
    right = (shared + 0.5 * rng.standard_normal(n)).astype(np.float32)
    win, hop, max_lag = 2400, 480, 240
    r = diffusion.stereo_diffusion_metrics(_t(left[None, :]), _t(right[None, :]), _lengths((1,), n),
                                           win, hop, max_lag)
    t_frames = 1 + (n - win) // hop
    for i in (0, t_frames - 1):
        wl, wr = left[i * hop : i * hop + win], right[i * hop : i * hop + win]
        assert abs(float(r.corr0[0, i]) - oracle.windowed_corr0(wl, wr)) < 1e-3
        assert abs(float(r.iacc_max[0, i]) - oracle.windowed_iacc_max(wl, wr, max_lag)) < 1e-3


def test_log_smoothing_reduces_variance_preserves_mean():
    n_fft = 4096
    freqs = np.fft.rfftfreq(n_fft, 1.0 / SR)
    mag = (np.random.default_rng(9).standard_normal(freqs.size) * 5.0).astype(np.float32)
    out = logfreq.smooth_mag_db_log_frequency(freqs, _t(mag[None, :]), 20.0, 20000.0, 15, 96).numpy()[0]
    sel = (freqs >= 100) & (freqs <= 10000)
    assert np.std(out[sel]) < 0.7 * np.std(mag[sel])
    outside = freqs < 20.0
    np.testing.assert_array_equal(out[outside], mag[outside])


def test_log_bin_aggregation_matches_direct_mean():
    n_fft = 2048
    freqs = np.fft.rfftfreq(n_fft, 1.0 / SR)
    edges = logfreq.build_log_bin_edges(20.0, 20000.0, 24, 24)
    centres, a, nonempty = logfreq.build_log_bin_matrix(freqs, edges)
    mag_db = (np.random.default_rng(10).standard_normal((freqs.size, 7)) * 10 - 40).astype(np.float32)
    got = logfreq.aggregate_db_to_log_bins(_t(mag_db.T[None, :, :]), _t(a)).numpy()[0]
    assert got.shape == (centres.size, 7)
    mag_lin = 10 ** (mag_db / 20.0)
    for b in np.nonzero(nonempty)[0][:10]:
        sel = (freqs >= edges[b]) & (freqs < edges[b + 1])
        expected = 20 * np.log10(np.maximum(mag_lin[sel].mean(axis=0), 1e-30))
        np.testing.assert_allclose(got[b], expected, atol=0.05)


# ----------------------------------------------------------------------------
# plot-facing math (tests/test_plotmath_vs_oracle.py)
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def decaying_noise():
    n = 1 << 16
    rng = np.random.default_rng(21)
    t = np.arange(n) / SR
    env = 10.0 ** (-3.0 * t / 0.5)
    x = np.zeros(n, np.float32)
    x[100:] = (0.1 * rng.standard_normal(n - 100) * env[: n - 100]).astype(np.float32)
    x[100] = 0.8
    return x


def _oracle_stft_of_trimmed(x, n_fft, hop):
    seg = np.asarray(x, np.float64)
    return oracle.stft_magnitude_db(seg[int(np.argmax(np.abs(seg))):], SR, n_fft, hop)


@pytest.mark.parametrize("db_reference", ["global_max", "slice_max"])
def test_waterfall_slices_match_oracle(decaying_noise, db_reference):
    settings = WaterfallAnalysisSettings(db_reference=db_reference)
    result = analyse_waterfall_for_channel(decaying_noise, SR, "mono", settings, device="cpu")
    t_o, f_o, mag_o = _oracle_stft_of_trimmed(decaying_noise, settings.n_fft, settings.hop_length)
    frame_idx = select_slice_frame_indices(t_o.astype(np.float32), settings)
    fmask = (f_o >= max(1.0, settings.f_min_hz)) & (f_o <= settings.f_max_hz)
    rel_o = oracle.waterfall_rel_db_slices(mag_o.T[frame_idx][:, fmask], db_reference, settings.dynamic_range_db)
    assert result.slice_magnitude_rel_db.shape == rel_o.shape
    np.testing.assert_allclose(result.slice_times_seconds, t_o[frame_idx].astype(np.float32), atol=1e-6)
    np.testing.assert_allclose(result.frequency_hz, f_o[fmask].astype(np.float32), atol=1e-3)
    np.testing.assert_allclose(result.slice_magnitude_rel_db, rel_o, atol=0.05)


def test_spectrogram_scale_matches_oracle(decaying_noise):
    analysis_settings = SpectrogramAnalysisSettings()
    plot_settings = SpectrogramPlotSettings()
    result = analyse_spectrogram_for_channel(decaying_noise, SR, "mono", analysis_settings, device="cpu")
    nyquist = 0.5 * SR
    fmask = (result.frequency_hz >= analysis_settings.f_min_hz) & (
        result.frequency_hz <= min(analysis_settings.f_max_hz, nyquist)
    )
    mag = result.magnitude_db[fmask, :]
    vmin, vmax = spectrogram_color_limits(mag, analysis_settings, plot_settings)
    vmin_o, vmax_o = oracle.spectrogram_color_scale(mag, analysis_settings.dynamic_range_db)
    assert vmax == pytest.approx(vmax_o, abs=1e-4)
    assert vmin == pytest.approx(vmin_o, abs=1e-4)
    t_o, f_o, mag_o = _oracle_stft_of_trimmed(decaying_noise, analysis_settings.n_fft, analysis_settings.hop_length)
    fmask_o = (f_o >= analysis_settings.f_min_hz) & (f_o <= min(analysis_settings.f_max_hz, nyquist))
    vmin_e2e, vmax_e2e = oracle.spectrogram_color_scale(mag_o[fmask_o, :], analysis_settings.dynamic_range_db)
    assert vmax == pytest.approx(vmax_e2e, abs=0.05)
    assert vmin == pytest.approx(vmin_e2e, abs=0.05)
    pinned = SpectrogramPlotSettings(vmin_db=-80.0, vmax_db=-10.0)
    assert spectrogram_color_limits(mag, analysis_settings, pinned) == (-80.0, -10.0)


# ----------------------------------------------------------------------------
# f32 EDC precision at 2^20 (tests/test_edc_precision.py)
# ----------------------------------------------------------------------------

N_PRECISION = 1 << 20


def _synth(rt60: float) -> np.ndarray:
    rng = np.random.default_rng(int(rt60 * 1000) % 2**31)
    t = np.arange(N_PRECISION) / SR
    x = (0.1 * rng.standard_normal(N_PRECISION) * 10.0 ** (-3.0 * t / rt60)).astype(np.float32)
    x[0] = 0.9
    return x


@pytest.mark.parametrize("rt60", [0.1, 1.0, 10.0, 90.0])
def test_edc_f32_matches_f64_oracle_at_2pow20(rt60):
    x = _synth(rt60)
    t_o, edc_o, _ = oracle.schroeder_edc_db(x.astype(np.float64), SR)
    fit_o = oracle.fit_decay_slope(t_o, edc_o, (-5.0, -35.0))
    curve = edc.schroeder_edc_db(_t(x[None, :]), _lengths((1,), N_PRECISION))
    edc_k = curve.edc_db[0].numpy()
    region = edc_o >= -80.0
    max_db_err = float(np.max(np.abs(edc_k[region] - edc_o[region])))
    assert max_db_err < 0.02, f"rt60={rt60}: max |dB err| {max_db_err}"
    fit_k = dbfit.fit_decay_slope_over_db_range(curve.edc_db, curve.length, (-5.0, -35.0), -80.0, SR)
    if fit_o is not None:
        assert bool(fit_k.ok[0])
        rt_k = float(fit_k.rt60_seconds[0])
        rel = abs(rt_k - float(fit_o[3])) / float(fit_o[3])
        assert rel < 5e-4, f"rt60={rt60}: kernel {rt_k} vs oracle {fit_o[3]} (rel {rel})"
