"""The port's per-file analyses (audio_analysis_tpu_torch/analyses) against
the JAX package's (CPU backend) on the same WAV files, with the same
settings carried across by `settings_from_jax`, on the CPU
(device="cpu": the plain torch versions of the kernels).

- On the golden IR (tests/golden_utils.make_golden_ir), each of the nine
  analyses with a vendored reference summary: the summary has the JAX
  summary's structure and its numbers within the per-module tolerance of
  tests/test_reference_parity.py (TOLERANCES); it also agrees with the
  reference tool's vendored output (tests/golden/reference/*.txt) within
  the same tolerances; and the --json tree has the JAX tree's keys. The
  z-plane (no vendored summary) runs at order 32 with zeros on the matrix's
  damped IR: its --json tree, complex poles and zeros included, has the
  JAX tree's keys and as many poles and zeros.
- Every settings variant of tests/parity_matrix.py (with its `ours_extra`,
  the --exact-grid ones, on both sides) and four more (decay --smoothing
  480, spectrogram n_fft 3000, modal cloud n_fft 32768, third-octave bands
  with a smoothed EDC), on the matrix's IRs of at most 2^16 samples: the
  same comparison with the variant's tolerance.
- Deconvolution: identical WAV header bytes; samples within 1e-4 of the
  peak of the JAX package's and 2e-4 of a float64 numpy deconvolution
  (reasons at the test).
"""

import json

import pytest

pytest.importorskip("jax")

import importlib  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
from scipy.io import wavfile  # noqa: E402

import golden_utils  # noqa: E402
import parity_matrix  # noqa: E402
from _summary_parity import assert_summaries_agree, json_skeleton  # noqa: E402
from audio_analysis_tpu.utils import jsonio as jjsonio  # noqa: E402
from audio_analysis_tpu_torch import analyses  # noqa: E402
from audio_analysis_tpu_torch.analyses import decay, spectrogram  # noqa: E402
from audio_analysis_tpu_torch.ops import edc, stft  # noqa: E402
from audio_analysis_tpu_torch.utils import jsonio  # noqa: E402
from test_reference_parity import FIXTURE_DIR, TOLERANCES  # noqa: E402

torch.set_num_threads(2)

# module -> (settings class, analyse entry, summary function)
MODULES = {
    "decay": ("DecayAnalysisSettings", "analyse_decay_from_wav_file", "summarise_decay_results_text"),
    "rt60bands": ("Rt60BandsAnalysisSettings", "analyse_rt60_bands_from_wav_file",
                  "summarise_rt60_bands_results_text"),
    "frequency_response": ("FrequencyResponseAnalysisSettings", "analyse_frequency_response_from_wav_file",
                           "summarise_frequency_response_results_text"),
    "spectrogram": ("SpectrogramAnalysisSettings", "analyse_spectrogram_from_wav_file",
                    "summarise_spectrogram_results_text"),
    "waterfall": ("WaterfallAnalysisSettings", "analyse_waterfall_from_wav_file",
                  "summarise_waterfall_results_text"),
    "modalcloud": ("ModalCloudAnalysisSettings", "analyse_modal_cloud_from_wav_file",
                   "summarise_modal_cloud_results_text"),
    "diffusion": ("DiffusionAnalysisSettings", "analyse_diffusion_from_wav_file",
                  "summarise_diffusion_results_text"),
    "group_delay": ("GroupDelayAnalysisSettings", "analyse_group_delay_from_wav_file",
                    "summarise_group_delay_results_text"),
    "filterplot": ("FilterAnalysisSettings", "analyse_filter_response_from_wav_file",
                   "summarise_filter_response_results_text"),
    "zplane": ("ZPlaneAnalysisSettings", "analyse_zplane_from_wav_file", "summarise_zplane_results_text"),
}
# the modules with a vendored reference summary of the golden IR
GOLDEN = sorted(m for m in MODULES if m != "zplane")
# (input, settings) of a module's golden run where they are not the golden
# IR at the defaults: order 256 is too slow for the CPU, and a long noisy
# tail puts every pole within about 2e-4 of the unit circle
GOLDEN_RUNS = {"zplane": ("damped", {"ar_order": 32, "derive_zeros": True, "zero_order": 16})}

EXTRA_VARIANTS = [
    dict(name="decay_smoothing_480", module="decay", input="noise",
         settings={"edc_smoothing_window_samples": 480, "compute_edt": True}),
    dict(name="sg_n_fft_3000", module="spectrogram", input="noise", settings={"n_fft": 3000}),
    dict(name="mc_n_fft_32768", module="modalcloud", input="modal", settings={"n_fft": 32768}),
    dict(name="rt60_third_smoothed", module="rt60bands", input="modal",
         settings={"band_mode": "third", "f_min_hz": 125.0, "f_max_hz": 8000.0},
         decay={"edc_smoothing_window_samples": 7},
         summary={"include_t20": False, "include_edt": False}, tol=(2e-3, 5e-3)),
]
VARIANTS = parity_matrix.VARIANTS + EXTRA_VARIANTS

def _jax_module(module: str):
    return importlib.import_module(f"audio_analysis_tpu.analyses.{module}")


def _port_module(module: str):
    return importlib.import_module(f"audio_analysis_tpu_torch.analyses.{module}")


def _summary(mod, module: str, results, summary_kwargs=None) -> str:
    fn = getattr(mod, MODULES[module][2])
    if module == "rt60bands":
        return fn(results, **(summary_kwargs or {"include_t20": False, "include_edt": False}))
    return fn(results)


def _write(path, ir):
    wavfile.write(str(path), parity_matrix.SR, (np.clip(ir, -1, 1) * 32767.0).astype(np.int16))
    return str(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("analyses")
    return {
        "noise": _write(root / "golden.wav", golden_utils.make_golden_ir()),
        "modal": _write(root / "modal.wav", parity_matrix.make_modal_ir()),
        "oddmono": _write(root / "oddmono.wav", parity_matrix.make_oddmono_ir()),
        "damped": _write(root / "damped.wav", parity_matrix.make_damped_ir()),
    }


def run_both(module: str, path: str, jax_settings):
    """(port results, JAX results) of one analysis on one file."""
    entry = MODULES[module][1]
    ours = getattr(_port_module(module), entry)(path, analyses.settings_from_jax(jax_settings), device="cpu")
    theirs = getattr(_jax_module(module), entry)(path, jax_settings)
    return ours, theirs


@pytest.fixture(scope="module")
def golden_runs(inputs):
    cache = {}

    def get(module):
        if module not in cache:
            name, kwargs = GOLDEN_RUNS.get(module, ("noise", {}))
            jax_settings = getattr(_jax_module(module), MODULES[module][0])(**kwargs)
            cache[module] = run_both(module, inputs[name], jax_settings)
        return cache[module]

    return get


@pytest.mark.parametrize("module", GOLDEN)
def test_golden_summary_matches_jax_and_reference(golden_runs, module):
    ours, theirs = golden_runs(module)
    got = _summary(_port_module(module), module, ours)
    rel, abs_ = TOLERANCES[module]
    assert_summaries_agree(_summary(_jax_module(module), module, theirs), got, rel, abs_, module)
    assert_summaries_agree((FIXTURE_DIR / f"{module}.txt").read_text(), got, rel, abs_, module + " vs reference")


@pytest.mark.parametrize("module", sorted(MODULES))
def test_results_json_has_the_jax_keys(golden_runs, module):
    ours, theirs = golden_runs(module)
    a = json.loads(jsonio.results_to_json(ours))
    b = json.loads(jjsonio.results_to_json(theirs))
    assert json_skeleton(a) == json_skeleton(b)


@pytest.mark.parametrize("variant", VARIANTS, ids=[v["name"] for v in VARIANTS])
def test_settings_variant_matches_jax(inputs, variant):
    module = variant["module"]
    jmod = _jax_module(module)
    kwargs = {**parity_matrix.settings_kwargs(variant), **variant.get("ours_extra", {})}
    if "decay" in variant:
        kwargs["decay_settings"] = jmod.DecayAnalysisSettings(**variant["decay"])
    jax_settings = getattr(jmod, MODULES[module][0])(**kwargs)
    ours, theirs = run_both(module, inputs[variant["input"]], jax_settings)
    rel, abs_ = variant["tol"] if "tol" in variant else TOLERANCES[module]
    summary = variant.get("summary")
    assert_summaries_agree(
        _summary(jmod, module, theirs, summary), _summary(_port_module(module), module, ours, summary),
        rel, abs_, variant["name"],
    )
    assert edc.EDC_KERNEL.launches == 0 and stft.STFT_KERNEL.launches == 0


@pytest.mark.parametrize(
    "name", sorted(analyses._SETTINGS),
)
def test_settings_from_jax_maps_every_field(name):
    jax_cls = next(
        getattr(_jax_module(m), name)
        for m in (*MODULES, "deconvolve", "impulse_response")
        if hasattr(_jax_module(m), name)
    )
    port = analyses.settings_from_jax(jax_cls())
    assert type(port).__name__ == name and port == type(port)()
    if name == "Rt60BandsAnalysisSettings":
        decay_settings = _jax_module("decay").DecayAnalysisSettings(edc_smoothing_window_samples=9)
        port = analyses.settings_from_jax(jax_cls(band_mode="third", decay_settings=decay_settings))
        assert port.decay_settings == decay.DecayAnalysisSettings(edc_smoothing_window_samples=9)
        assert port.band_mode == "third"


def test_per_channel_entries_match_the_file_entries():
    ir = golden_utils.make_golden_ir()
    got = decay.analyse_decay_for_channel(ir[:, 1], 48_000, "right", decay.DecayAnalysisSettings(), device="cpu")
    files = decay.analyse_decay_channels(
        analyses._common.FileDsp([("left", ir[:, 0]), ("right", ir[:, 1])], 48_000, "cpu"),
        decay.DecayAnalysisSettings(),
    )
    assert decay.summarise_decay_results_text([got]) == decay.summarise_decay_results_text(files[1:])
    sg = spectrogram.analyse_spectrogram_for_channel(ir[:, 0], 48_000, "mono", spectrogram.SpectrogramAnalysisSettings(), "cpu")
    assert sg.magnitude_db.shape == (2049, 120) and sg.channel_name == "mono"


@pytest.fixture(scope="module")
def sweep_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("deconvolve")
    sweep = _write(root / "sweep.wav", parity_matrix.make_sweep())
    recorded = _write(root / "recorded.wav", parity_matrix.make_recorded(golden_utils.make_golden_ir()))
    return root, sweep, recorded


def _deconvolve_f64(recorded_path, sweep_path, settings) -> np.ndarray:
    """The deconvolution in float64 numpy from the same decoded samples."""
    rec = wavfile.read(recorded_path)[1].astype(np.float64) / 32768.0
    sweep = wavfile.read(sweep_path)[1].astype(np.float64) / 32768.0
    n_fft = 1 << (max(rec.shape[0], sweep.size) - 1).bit_length()
    spec_x = np.fft.rfft(sweep, n_fft)
    power = np.abs(spec_x) ** 2
    h = np.fft.rfft(rec, n_fft, axis=0) * np.conj(spec_x)[:, None] / (
        power + settings.regularization_relative * power.max()
    )[:, None]
    ir = np.fft.irfft(h, n_fft, axis=0)
    if settings.output_length_mode == "recorded":
        ir = ir[: rec.shape[0]]
    if settings.remove_dc:
        ir = ir - ir.mean(axis=0, keepdims=True)
    if settings.normalise_peak:
        ir = ir * (settings.target_peak / np.abs(ir).max())
    return ir


def _data_offset(raw: bytes) -> int:
    return raw.index(b"data") + 8


@pytest.mark.parametrize(
    "variant", parity_matrix.DECONVOLVE_VARIANTS, ids=[v["name"] for v in parity_matrix.DECONVOLVE_VARIANTS]
)
def test_deconvolve_matches_jax(sweep_files, variant):
    from audio_analysis_tpu.analyses import deconvolve as jdeconvolve
    from audio_analysis_tpu_torch.analyses import deconvolve as tdeconvolve

    root, sweep, recorded = sweep_files
    jax_settings = jdeconvolve.DeconvolveSettings(**variant["settings"])
    ours = tdeconvolve.deconvolve_from_wav_files(
        recorded, sweep, analyses.settings_from_jax(jax_settings), root / "ours.wav", device="cpu"
    )
    theirs = jdeconvolve.deconvolve_from_wav_files(recorded, sweep, jax_settings, root / "theirs.wav")
    assert ours.samples.shape == theirs.samples.shape and ours.samples.dtype == np.float32
    assert (ours.sample_rate_hz, ours.recorded_file_path, ours.sweep_file_path) == (
        theirs.sample_rate_hz, theirs.recorded_file_path, theirs.sweep_file_path
    )
    # with a 1e-10 regularisation the inverse amplifies each side's float32
    # FFT rounding where the sweep has little energy (below 20 Hz, above
    # 20 kHz): the JAX package holds itself to the float64 reference tool at
    # 2e-4 of the peak (tests/test_reference_parity_matrix.py); the port is
    # held to float64 numpy at that bound and to the JAX package at 1e-4
    peak = np.abs(theirs.samples).max()
    assert np.abs(ours.samples - theirs.samples).max() <= 1e-4 * peak
    assert np.abs(ours.samples - _deconvolve_f64(recorded, sweep, jax_settings)).max() <= 2e-4 * peak
    a, b = (root / "ours.wav").read_bytes(), (root / "theirs.wav").read_bytes()
    assert len(a) == len(b) and a[: _data_offset(a)] == b[: _data_offset(b)]
    assert tdeconvolve.default_output_ir_path(recorded) == jdeconvolve.default_output_ir_path(recorded)
