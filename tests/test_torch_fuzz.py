"""Settings-space fuzz of the port's per-file analyses against the JAX
package's, and of the kernels' plain versions against the port's float64
oracle, on the CPU (hypothesis).

- Per-file settings: decay, rt60bands, fr, groupdelay, spectrogram,
  waterfall, modalcloud, diffusion and filter (zplane, deconvolve, the IR
  view and the gen CLI: tests/test_torch_fuzz_rest.py). Each example draws
  one analysis' settings and one of three WAV files (the golden noise IR of
  tests/golden_utils.py and the modal and damped IRs of
  tests/parity_matrix.py), carries the JAX settings across with
  `settings_from_jax`, and runs the port (device="cpu": the plain
  versions) and the JAX package (CPU backend) on the file. Their text
  summaries must agree within the per-module tolerances of
  tests/test_reference_parity.py (TOLERANCES) and their --json trees must
  have the same keys; where the JAX package raises, the port raises the
  same exception class.
- `ops/edc.py schroeder_edc_db_plain` against `oracle.schroeder_edc_db`
  (no trim): rows, N and ragged lengths (0 and 1 among them), eps and a
  floor that may be -inf. Within 0.02 dB wherever the oracle's curve is
  at or above -80 dB (tests/test_edc_precision.py), exactly 0 past
  `length`, exactly 0 dB at index 0.
- `ops/stft.py stft_magnitude_plain` against `oracle.stft_magnitude_db`:
  every n_fft of K2 (powers of two 256-16384) and sizes outside it, hops
  that do and do not divide n_fft, k_out, the floor and the Hann window on
  or off, ragged lengths. The oracle's magnitude (10^(dB/20)) within 1e-5
  of its largest value (chip_smoke.py's kernel-vs-plain rule), its frame
  count, frames past the valid length exactly 0.

Hypothesis runs derandomized (`derandomize=True`, no example database), so
every run draws the same examples and counts the same; the known edges are
`@example`s.
"""

import dataclasses
import json

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from hypothesis import HealthCheck, example, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from scipy.io import wavfile  # noqa: E402

import golden_utils  # noqa: E402
import parity_matrix  # noqa: E402
from _summary_parity import assert_summaries_agree, json_skeleton  # noqa: E402
from audio_analysis_tpu.utils import jsonio as jjsonio  # noqa: E402
from audio_analysis_tpu_torch import analyses, oracle  # noqa: E402
from audio_analysis_tpu_torch.ops import edc, stft  # noqa: E402
from audio_analysis_tpu_torch.utils import jsonio  # noqa: E402
from test_reference_parity import TOLERANCES  # noqa: E402
from test_torch_analyses import MODULES, _jax_module, _port_module, _summary  # noqa: E402

torch.set_num_threads(2)

SR = 48_000
PER_FILE = settings(
    derandomize=True, database=None, deadline=None, max_examples=3,
    suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large],
)
CHEAP = settings(
    derandomize=True, database=None, deadline=None, max_examples=60,
    suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large],
)
K2_SIZES = (256, 512, 1024, 2048, 4096, 8192, 16384)
INPUTS = ("noise", "modal", "damped")


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fuzz")
    out = {}
    for name, ir in (("noise", golden_utils.make_golden_ir()), ("modal", parity_matrix.make_modal_ir()),
                     ("damped", parity_matrix.make_damped_ir())):
        out[name] = str(root / f"{name}.wav")
        wavfile.write(out[name], SR, (np.clip(ir, -1, 1) * 32767.0).astype(np.int16))
    return out


# ------------------------------------------------------------ per-file ----


def _range(high, span):
    return st.tuples(st.sampled_from(high), st.sampled_from(span)).map(lambda hs: (hs[0], hs[0] - hs[1]))


def _common():
    return {
        "use_mono_downmix_for_stereo": st.booleans(),
        "trim_to_peak": st.booleans(),
        "ignore_leading_seconds": st.sampled_from([0.0, 0.002, 0.01]),
    }


def _n_fft():
    """Inside K2's range or outside it (not a power of two, below 256, above
    16384)."""
    return st.one_of(st.sampled_from(K2_SIZES), st.sampled_from([128, 1000, 3000, 6000, 20000]))


def _framed():
    return {
        **_common(),
        "analysis_duration_seconds": st.sampled_from([None, 0.3]),
        "n_fft": _n_fft(),
        "hop_length": st.sampled_from([64, 256, 333, 512, 1024]),
        "use_hann_window": st.booleans(),
        "f_min_hz": st.sampled_from([20.0, 100.0]),
        "f_max_hz": st.sampled_from([8000.0, 20000.0]),
    }


def _decay():
    return {
        **_common(),
        "edc_floor_db": st.sampled_from([-150.0, -120.0, -90.0]),
        "edc_epsilon": st.sampled_from([1e-30, 1e-20, 1e-12]),
        "fit_lower_limit_db": st.sampled_from([-80.0, -60.0]),
        "t20_range_db": _range([-5.0, -3.0], [15.0, 20.0]),
        "t30_range_db": _range([-5.0, -8.0], [25.0, 30.0]),
        "compute_edt": st.booleans(),
        "edt_range_db": _range([0.0, -1.0], [8.0, 10.0]),
        "edc_smoothing_window_samples": st.sampled_from([0, 1, 9, 480]),
    }


SETTINGS = {
    "decay": _decay(),
    "rt60bands": {
        "band_mode": st.sampled_from(["three", "octave", "third"]),
        "low_upper_hz": st.sampled_from([200.0, 250.0, 300.0]),
        "mid_center_hz": st.sampled_from([800.0, 1000.0]),
        "mid_width_octaves": st.sampled_from([1.0, 2.0]),
        "high_lower_hz": st.sampled_from([3000.0, 4000.0]),
        "f_min_hz": st.sampled_from([31.5, 125.0]),
        "f_max_hz": st.sampled_from([8000.0, 16000.0]),
        "transition_width_octaves": st.sampled_from([1 / 6, 0.25, 0.5]),
        "include_t20": st.booleans(),
        "include_edt": st.booleans(),
    },
    "frequency_response": {
        **_common(),
        "analysis_duration_seconds": st.sampled_from([None, 0.5]),
        "use_hann_window": st.booleans(),
        "magnitude_floor_db": st.sampled_from([-140.0, -120.0]),
        "f_min_hz": st.sampled_from([20.0, 50.0]),
        "f_max_hz": st.sampled_from([10000.0, 20000.0]),
        "smoothing_log_bins": st.sampled_from([0, 5, 9]),
        "log_bins_per_octave": st.sampled_from([48, 96]),
        "exact_grid": st.booleans(),
    },
    "group_delay": {
        **_common(),
        "analysis_duration_seconds": st.sampled_from([None, 0.5]),
        "exact_grid": st.booleans(),
        "use_hann_window": st.booleans(),
        "fft_size": st.sampled_from([None, 65536, 131072]),
        "f_min_hz": st.sampled_from([20.0, 100.0]),
        "f_max_hz": st.sampled_from([10000.0, 20000.0]),
        "unwrap_phase": st.just(True),
        "smoothing_bins": st.sampled_from([0, 9, 33]),
    },
    "spectrogram": {
        **_framed(),
        "floor_db": st.sampled_from([-140.0, -120.0, -100.0]),
        "dynamic_range_db": st.sampled_from([None, 60.0, 90.0]),
    },
    "waterfall": {
        **_framed(),
        "slice_mode": st.sampled_from(["auto", "uniform_time", "uniform_frames"]),
        "num_slices": st.sampled_from([6, 18]),
        "slice_spacing_seconds": st.sampled_from([0.02, 0.05]),
        "start_time_seconds": st.sampled_from([0.0, 0.05]),
        "end_time_seconds": st.sampled_from([None, 0.8]),
        "log_bins_per_octave": st.sampled_from([48, 96]),
        "db_reference": st.sampled_from(["global_max", "slice_max"]),
        "smoothing_log_bins": st.sampled_from([0, 5]),
        "dynamic_range_db": st.sampled_from([60.0, 80.0]),
        "floor_db": st.sampled_from([-120.0, -100.0]),
    },
    "modalcloud": {
        **_framed(),
        "log_bins_per_octave": st.sampled_from([12, 24]),
        "min_bins": st.sampled_from([12, 24]),
        "floor_db": st.sampled_from([-120.0, -100.0]),
        "metric": st.sampled_from(["t30", "t20", "edt"]),
        "fit_lower_limit_db": st.sampled_from([-80.0, -60.0]),
        "t30_range_db": _range([-5.0, -8.0], [25.0, 30.0]),
        "t20_range_db": _range([-5.0, -3.0], [15.0, 20.0]),
        "edt_range_db": _range([0.0, -1.0], [8.0, 10.0]),
        "min_fit_points": st.sampled_from([8, 10]),
        "min_peak_db_above_floor": st.sampled_from([20.0, 30.0]),
    },
    "filterplot": {
        **_common(),
        "analysis_duration_seconds": st.sampled_from([None, 0.3, 1.0]),
        "use_hann_window": st.booleans(),
        "magnitude_floor_db": st.sampled_from([-140.0, -120.0, -100.0]),
        "f_min_hz": st.sampled_from([20.0, 50.0]),
        "f_max_hz": st.sampled_from([10000.0, 20000.0]),
        "phase_mode": st.sampled_from(["degrees", "radians"]),
        "unwrap_phase": st.booleans(),
        "exact_grid": st.booleans(),
    },
    "diffusion": {
        **_common(),
        "window_seconds": st.sampled_from([0.01, 0.03, 0.05]),
        "hop_seconds": st.sampled_from([0.005, 0.01, 0.013]),
        "max_lag_milliseconds": st.sampled_from([1.0, 5.0, 10.0]),
        "echo_density_threshold_rms": st.sampled_from([1.0, 1.5]),
        "echo_density_normalise_to_gaussian": st.booleans(),
    },
}


def assert_per_file_agrees(module: str, path: str, fields: dict) -> None:
    jax_settings = getattr(_jax_module(module), MODULES[module][0])(**fields)
    entry = MODULES[module][1]
    try:
        theirs = getattr(_jax_module(module), entry)(path, jax_settings)
    except Exception as exc:  # the port must refuse the same settings the same way
        with pytest.raises(type(exc)):
            getattr(_port_module(module), entry)(path, analyses.settings_from_jax(jax_settings), device="cpu")
        return
    finally:
        jax.clear_caches()
    ours = getattr(_port_module(module), entry)(path, analyses.settings_from_jax(jax_settings), device="cpu")
    summary = (
        {"include_t20": jax_settings.include_t20, "include_edt": jax_settings.include_edt}
        if module == "rt60bands" else None
    )
    rel, abs_ = TOLERANCES[module]
    assert_summaries_agree(
        _summary(_jax_module(module), module, theirs, summary),
        _summary(_port_module(module), module, ours, summary), rel, abs_, f"{module} {fields}",
    )
    assert json_skeleton(json.loads(jsonio.results_to_json(ours))) == json_skeleton(
        json.loads(jjsonio.results_to_json(theirs))
    )


def _module_test(module: str, extra_examples=()):
    @PER_FILE
    @given(fields=st.fixed_dictionaries(SETTINGS[module]), wav=st.sampled_from(INPUTS))
    def run(wavs, fields, wav):
        assert_per_file_agrees(module, wavs[wav], fields)

    for fields, wav in extra_examples:
        run = example(fields=fields, wav=wav)(run)
    return run


# the frame analyses at n_fft outside K2's range, and with no frame at all
# (the 8192-sample damped IR, trimmed at its onset, is shorter than 16384)
NO_FRAME = {"n_fft": 16384, "hop_length": 512}
test_decay_settings_match_jax = _module_test("decay", [({"edc_smoothing_window_samples": 480, "compute_edt": True,
                                                          "trim_to_peak": False}, "noise")])
test_rt60bands_settings_match_jax = _module_test("rt60bands", [({"band_mode": "third", "f_min_hz": 125.0,
                                                                 "f_max_hz": 8000.0}, "modal")])
test_fr_settings_match_jax = _module_test("frequency_response")
test_groupdelay_settings_match_jax = _module_test("group_delay")
test_spectrogram_settings_match_jax = _module_test(
    "spectrogram", [({"n_fft": 3000, "hop_length": 333}, "noise"), ({"n_fft": 128, "hop_length": 64}, "damped"),
                    (NO_FRAME, "damped")])
test_waterfall_settings_match_jax = _module_test(
    "waterfall", [({"n_fft": 20000, "hop_length": 1024}, "noise"), (NO_FRAME, "damped")])
test_modalcloud_settings_match_jax = _module_test(
    "modalcloud", [({"n_fft": 6000, "hop_length": 256}, "modal"), (NO_FRAME, "damped")])
test_diffusion_settings_match_jax = _module_test("diffusion")
test_filterplot_settings_match_jax = _module_test(
    "filterplot", [({"exact_grid": True, "analysis_duration_seconds": 0.3, "phase_mode": "radians"}, "modal"),
                   ({"use_hann_window": False, "unwrap_phase": False, "trim_to_peak": False}, "damped")])


def test_every_per_file_setting_is_drawn():
    """Every settings field of the nine analyses here, and of zplane,
    deconvolve and the IR view (tests/test_torch_fuzz_rest.py), is drawn
    but rt60bands' decay settings (the decay test draws those)."""
    from test_torch_fuzz_rest import DECONVOLVE, IR_VIEW, ZPLANE

    drawn = {**{(m, MODULES[m][0]): strategies for m, strategies in SETTINGS.items()},
             ("zplane", "ZPlaneAnalysisSettings"): ZPLANE, ("deconvolve", "DeconvolveSettings"): DECONVOLVE,
             ("impulse_response", "ImpulseResponseViewSettings"): IR_VIEW}
    assert len(drawn) == 12
    for (module, name), strategies in drawn.items():
        fields = {f.name for f in dataclasses.fields(getattr(_port_module(module), name))} - {"decay_settings"}
        assert set(strategies) == fields, module


# ------------------------------------------------- kernels' plain versions ----


@st.composite
def edc_draws(draw):
    n = draw(st.sampled_from([1, 2, 5, 64, 1000, 4097, 1 << 14]))
    rows = draw(st.integers(1, 4))
    lengths = [draw(st.sampled_from([0, 1, n, min(n, 4), max(0, n - 1)]) | st.integers(0, n)) for _ in range(rows)]
    return (n, lengths, draw(st.integers(0, 2**31 - 1)), draw(st.sampled_from([1e-30, 1e-20, 1e-12, 1e-6])),
            draw(st.sampled_from([-120.0, -90.0, -60.0, -np.inf])))


@CHEAP
@given(draw=edc_draws())
@example(draw=(5, [0, 1, 2, 5], 1, 1e-20, -120.0))
@example(draw=(1 << 14, [1 << 14, 1, 0], 2, 1e-30, -np.inf))
def test_edc_plain_matches_the_oracle(draw):
    n, lengths, seed, eps, floor = draw
    rng = np.random.default_rng(seed)
    tau = rng.uniform(5.0, 4.0 * n + 5.0, size=(len(lengths), 1))
    x = (rng.standard_normal((len(lengths), n)) * np.exp(-np.arange(n) / tau)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    x[np.arange(n)[None, :] >= lens[:, None]] = 0.0
    got = edc.schroeder_edc_db_plain(torch.from_numpy(x), torch.from_numpy(lens), eps, floor).numpy()
    for row, length in enumerate(lengths):
        assert np.all(got[row, length:] == 0.0)
        if length == 0:
            continue
        assert got[row, 0] == 0.0
        if length < 4:  # the oracle's minimum segment
            continue
        _, ref, _ = oracle.schroeder_edc_db(x[row, :length], SR, False, 0.0, eps, floor)
        region = ref >= -80.0
        np.testing.assert_allclose(got[row, :length][region], ref[region], atol=0.02, err_msg=str(draw))


@st.composite
def stft_draws(draw):
    n_fft = draw(st.sampled_from(K2_SIZES) | st.sampled_from([100, 300, 1000, 3000, 5000]))
    hop = draw(st.sampled_from([n_fft // 8, n_fft // 4, n_fft // 2, n_fft]) | st.integers(max(1, n_fft // 8), n_fft))
    n = draw(st.integers(n_fft // 2, n_fft + 12 * hop))
    rows = draw(st.integers(1, 3))
    lengths = [draw(st.sampled_from([n, 0, 1, n_fft - 1, n_fft]) | st.integers(0, n)) for _ in range(rows)]
    f_bins = n_fft // 2 + 1
    k_out = draw(st.sampled_from([None, f_bins, 1]) | st.integers(1, f_bins))
    return (n_fft, hop, n, [min(length, n) for length in lengths], k_out, draw(st.sampled_from([-200.0, -120.0, -60.0])),
            draw(st.booleans()), draw(st.integers(0, 2**31 - 1)))


@CHEAP
@given(draw=stft_draws())
@example(draw=(4096, 512, 3000, [3000, 0], None, -120.0, True, 1))  # no frame
@example(draw=(16384, 1000, 20000, [20000, 17000, 16384], 3415, -120.0, True, 2))
@example(draw=(3000, 1001, 9000, [9000, 4000], None, -60.0, False, 3))
def test_stft_plain_matches_the_oracle(draw):
    n_fft, hop, n, lengths, k_out, floor_db, hann, seed = draw
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((len(lengths), n)) * np.exp(-np.arange(n) / (0.5 * n + 1.0))).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    x[np.arange(n)[None, :] >= lens[:, None]] = 0.0
    floor_lin = 10.0 ** (floor_db / 20.0)
    got = stft.stft_magnitude_plain(torch.from_numpy(x), torch.from_numpy(lens), n_fft, hop, hann, floor_lin,
                                    k_out).numpy()
    frames = stft.num_frames_static(n, n_fft, hop)
    k = n_fft // 2 + 1 if k_out is None else k_out
    assert got.shape == (len(lengths), frames, k), draw
    for row, length in enumerate(lengths):
        valid = stft.num_frames_static(length, n_fft, hop)
        assert np.all(got[row, valid:] == 0.0), draw
        if valid == 0:
            continue
        _, _, ref_db = oracle.stft_magnitude_db(x[row, :length], SR, n_fft, hop, hann, floor_db)
        ref = 10.0 ** (ref_db[:k].T / 20.0)
        assert ref.shape == (valid, k), draw
        assert np.max(np.abs(got[row, :valid] - ref)) <= 1e-5 * np.max(ref), draw
