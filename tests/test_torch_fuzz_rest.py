"""Settings-space fuzz of the port's z-plane, deconvolution, IR view and
gen CLI against the JAX package's, and of the z-plane's AR fit and the
deconvolution against float64 references, on the CPU (hypothesis).

- zplane: every ZPlaneAnalysisSettings field (ar_order 8-64, ridge 0,
  1e-6, 1e-5, zeros of order 4-16, the segment normalisation, trim,
  leading seconds, duration) on the damped and modal IRs of
  tests/parity_matrix.py. Against the JAX package: each channel's pole,
  zero and unstable-pole counts exactly; max|p| and median|p| within
  tests/parity_matrix.py's z-plane tolerances (2e-2 relative at order <=
  16, 8e-2 above it: the float32 Gram against float64, its comment says
  why); the same --json keys. Inputs with long noisy tails are not drawn:
  their poles sit within about 2e-4 of the unit circle, where neither
  package's float32 fit settles an unstable count (parity_matrix.py
  `make_damped_ir`).
- The AR fit against float64 on the port's own segment: the float32 Gram
  within GRAM_REL_ERR of the float64 Gram of the oracle's design matrix
  (oracle.fit_ar_least_squares builds it), and the coefficients within the
  first-order error of a truncated solve. The port, like the JAX package,
  drops singular directions of the Gram below rcond = 1e-6 of the largest
  (ops/spectral.solve_ar_coefficients; docs/MIGRATION.md). The oracle's
  full-rank solve keeps them; on these inputs the Gram's condition number
  is 1e6-6e9, and the two solutions differ by 1-96%, so the coefficients
  are held to the same truncated problem solved in float64 (an SVD of the
  oracle's design matrix, with the ridge as extra rows). A relative Gram
  error e moves the kept solution by at most about e * lmax / lmin (the
  largest and the smallest kept eigenvalue): that is the limit, with e =
  GRAM_REL_ERR. Where the float32 Gram keeps another number of directions
  than the float64 one (an eigenvalue within the Gram's error of the
  cutoff), the solve is discontinuous: there only the counts are held.
- deconvolve: every DeconvolveSettings field (regularisation 1e-12, 1e-10,
  1e-8, both output lengths, the peak normalisation and its target, the DC
  removal) on recordings of drawn length and channel count (the IRs of
  tests/golden_utils.py and tests/parity_matrix.py through its
  `make_sweep` sweep). The IR waveform against the JAX package's and
  against `oracle.deconvolve` (float64, the same decoded samples; the
  full_fft length by zero-padding the recording to the FFT size), within
  tests/_fuzz_spaces.py's DECONVOLVE_TOL of the reference's peak (its
  docstring says how they were measured).
- ir: every ImpulseResponseViewSettings field on mono and stereo files of
  drawn length. The view has no trim or leading-seconds setting; its
  results (peak index and value, length and duration per channel) equal
  the JAX package's exactly, through the analysis and the CLI's --json.
- gen: every subcommand of the gen CLI with drawn flags
  (tests/_fuzz_spaces.py GEN_FLAGS), mono or stereo, at
  48 or 44.1 kHz: the same stdout and WAV file names; the WAV bytes equal,
  except Karplus-Strong (float32 in another operation order than the JAX
  scan), whose header bytes are equal and samples within 1 PCM16 LSB, as
  tests/test_torch_signals.py holds it at fixed settings.

Hypothesis runs derandomized (`derandomize=True`, no example database), so
every run draws the same examples and counts the same.
"""

import contextlib
import io
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
from _fuzz_spaces import DECONVOLVE_TOL, GEN_FLAGS  # noqa: E402
from _summary_parity import json_skeleton  # noqa: E402
from audio_analysis_tpu.analyses import deconvolve as jdeconvolve  # noqa: E402
from audio_analysis_tpu.analyses import impulse_response as jimpulse  # noqa: E402
from audio_analysis_tpu.analyses import zplane as jzplane  # noqa: E402
from audio_analysis_tpu.cli import gen_cli as jax_gen  # noqa: E402
from audio_analysis_tpu.utils import jsonio as jjsonio  # noqa: E402
from audio_analysis_tpu_torch import analyses, oracle  # noqa: E402
from audio_analysis_tpu_torch.analyses import deconvolve, impulse_response, zplane  # noqa: E402
from audio_analysis_tpu_torch.analyses._common import FileDsp  # noqa: E402
from audio_analysis_tpu_torch.cli import gen_cli as torch_gen  # noqa: E402
from audio_analysis_tpu_torch.cli.analyse_cli import main as cli_main  # noqa: E402
from audio_analysis_tpu_torch.ops import edc, spectral, stft  # noqa: E402
from audio_analysis_tpu_torch.utils import jsonio  # noqa: E402

torch.set_num_threads(2)

SR = 48_000
DRAWS = settings(
    derandomize=True, database=None, deadline=None, max_examples=10,
    suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large, HealthCheck.function_scoped_fixture],
)
GEN_DRAWS = settings(DRAWS, max_examples=2)

# the float32 Gram's relative Frobenius error against float64: 3.6e-7 on an
# H100 (chip_smoke.py phase 9), 0.7-5.6e-7 on the CPU; the limit leaves a
# margin over both
GRAM_REL_ERR = 1e-6
RCOND = 1e-6  # ops/spectral.solve_ar_coefficients
# (relative, absolute) radius tolerances of tests/parity_matrix.py's z-plane
# variants: order <= 16, and above it
ZPLANE_TOL = {16: (2e-2, 5e-3), 64: (8e-2, 5e-3)}



def _write(path, x):
    wavfile.write(str(path), SR, (np.clip(x, -1, 1) * 32767.0).astype(np.int16))
    return str(path)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fuzz_rest")
    return {
        "root": root,
        "modal": _write(root / "modal.wav", parity_matrix.make_modal_ir()),
        "damped": _write(root / "damped.wav", parity_matrix.make_damped_ir()),
        "sweep": _write(root / "sweep.wav", parity_matrix.make_sweep()),
    }


def _irs():
    return {"noise": golden_utils.make_golden_ir(), "modal": parity_matrix.make_modal_ir(),
            "damped": parity_matrix.make_damped_ir()}


# ---------------------------------------------------------------- zplane ----

ZPLANE = {
    "use_mono_downmix_for_stereo": st.booleans(),
    "trim_to_peak": st.booleans(),
    "ignore_leading_seconds": st.sampled_from([0.0, 0.002, 0.01]),
    "analysis_duration_seconds": st.sampled_from([None, 0.05, 0.1]),
    "model": st.just("ar"),
    "ar_order": st.sampled_from([8, 16, 32, 64]),
    "derive_zeros": st.booleans(),
    "zero_order": st.sampled_from([4, 8, 16]),
    "normalise_segment": st.booleans(),
    "ridge_lambda": st.sampled_from([0.0, 1e-6, 1e-5]),
}


def _design(seg: np.ndarray, p: int):
    """The covariance-method design matrix and target of
    oracle.fit_ar_least_squares: rows n = p..N-1, A[:, k-1] = x[n-k],
    y = -x[n]."""
    n = seg.size
    return np.stack([seg[p - k: n - k] for k in range(1, p + 1)], axis=1), -seg[p:n]


def assert_ar_fit_matches_float64(dsp: FileDsp, s) -> int:
    """The port's AR fit of each channel against float64 on its own
    segment; returns how many channels sat on the truncation's knife edge
    (coefficients not compared)."""
    knife_edges = 0
    for a, seg in zip(zplane.fit_ar_channels(dsp, s), zplane.host_segments(dsp, s)):
        p = a.size - 1
        design, target = _design(seg, p)
        got = spectral.ar_normal_equations(torch.from_numpy(seg.astype(np.float32))[None],
                                           torch.tensor([seg.size]), p)
        gram = design.T @ design
        err = np.linalg.norm(got.gram[0].double().numpy() - gram) / np.linalg.norm(gram)
        assert err <= GRAM_REL_ERR, (s, err)
        ridge = float(s.ridge_lambda)
        if ridge > 0.0:
            design = np.vstack([design, np.sqrt(ridge) * np.eye(p)])
            target = np.concatenate([target, np.zeros(p)])
        u, sv, vt = np.linalg.svd(design, full_matrices=False)
        eig = sv**2  # the eigenvalues of the Gram (plus the ridge)
        keep = eig > RCOND * eig[0]
        ref = np.concatenate(([1.0], vt[keep].T @ ((u[:, keep].T @ target) / sv[keep])))
        ours = np.linalg.svd(got.gram[0].double().numpy() + ridge * np.eye(p), compute_uv=False)
        if int(np.sum(ours > RCOND * ours[0])) != int(keep.sum()):
            knife_edges += 1
            continue
        limit = GRAM_REL_ERR * eig[0] / eig[keep].min()
        assert np.linalg.norm(a - ref) <= limit * np.linalg.norm(ref), (s, np.linalg.norm(a - ref) / np.linalg.norm(ref),
                                                                       limit)
    return knife_edges


def _radii(result):
    r = np.abs(result.poles)
    return float(np.max(r)), float(np.median(r))


@DRAWS
@given(fields=st.fixed_dictionaries(ZPLANE), wav=st.sampled_from(["damped", "modal"]))
@example(fields={"ar_order": 64, "ridge_lambda": 1e-5, "derive_zeros": True, "zero_order": 16}, wav="damped")
@example(fields={"ar_order": 8, "ignore_leading_seconds": 0.01}, wav="modal")  # a knife edge
def test_zplane_settings_match_jax_and_float64(wavs, fields, wav):
    jax_settings = jzplane.ZPlaneAnalysisSettings(**fields)
    ours_settings = analyses.settings_from_jax(jax_settings)
    theirs = jzplane.analyse_zplane_from_wav_file(wavs[wav], jax_settings)
    jax.clear_caches()
    dsp = FileDsp.from_wav_file(wavs[wav], ours_settings.use_mono_downmix_for_stereo, "cpu")
    ours = zplane.analyse_zplane_from_wav_file(wavs[wav], ours_settings, dsp=dsp, device="cpu")
    rel, abs_ = ZPLANE_TOL[16 if fields["ar_order"] <= 16 else 64]
    assert [r.channel_name for r in ours] == [r.channel_name for r in theirs]
    for a, b in zip(ours, theirs):
        assert a.poles.size == b.poles.size, fields
        assert int(np.sum(np.abs(a.poles) >= 1.0)) == int(np.sum(np.abs(b.poles) >= 1.0)), fields
        assert (a.zeros is None) == (b.zeros is None) and (a.zeros is None or a.zeros.size == b.zeros.size), fields
        for x, y in zip(_radii(a), _radii(b)):
            assert abs(x - y) <= max(abs_, rel * max(abs(x), abs(y))), (fields, _radii(a), _radii(b))
    assert json_skeleton(json.loads(jsonio.results_to_json(ours))) == json_skeleton(
        json.loads(jjsonio.results_to_json(theirs)))
    assert_ar_fit_matches_float64(dsp, ours_settings)
    assert edc.EDC_KERNEL.launches == 0 and stft.STFT_KERNEL.launches == 0


def test_the_knife_edge_is_detected(wavs):
    """modal, order 8, 10 ms skipped: an eigenvalue of one channel's Gram
    sits at the cutoff, and the float32 Gram keeps one direction more than
    the float64 one (the coefficients then differ by 2.4x their norm)."""
    s = zplane.ZPlaneAnalysisSettings(ar_order=8, ignore_leading_seconds=0.01, normalise_segment=False)
    assert assert_ar_fit_matches_float64(FileDsp.from_wav_file(wavs["modal"], False, "cpu"), s) >= 1


# ------------------------------------------------------------ deconvolve ----

DECONVOLVE = {
    "regularization_relative": st.sampled_from([1e-12, 1e-10, 1e-8]),
    "normalise_peak": st.booleans(),
    "target_peak": st.sampled_from([0.5, 0.95, 1.0]),
    "remove_dc": st.booleans(),
    "output_length_mode": st.sampled_from(["recorded", "full_fft"]),
}


def _oracle_ir(recorded_path, sweep_path, s) -> np.ndarray:
    """oracle.deconvolve of the decoded samples, then the settings' output
    length, DC removal and peak normalisation, in float64."""
    rec = wavfile.read(recorded_path)[1].astype(np.float64) / 32768.0
    rec = rec.reshape(rec.shape[0], -1)
    sweep = wavfile.read(sweep_path)[1].astype(np.float64) / 32768.0
    n_fft = 1 << (max(rec.shape[0], sweep.size) - 1).bit_length()
    if s.output_length_mode == "full_fft":  # zero padding leaves the FFT unchanged
        rec = np.concatenate([rec, np.zeros((n_fft - rec.shape[0], rec.shape[1]))])
    ir = oracle.deconvolve(rec, sweep, s.regularization_relative)
    if s.remove_dc:
        ir = ir - ir.mean(axis=0, keepdims=True)
    if s.normalise_peak:
        ir = ir * (s.target_peak / np.abs(ir).max())
    return ir


@DRAWS
@given(fields=st.fixed_dictionaries(DECONVOLVE), ir=st.sampled_from(["noise", "modal", "damped"]),
       length=st.sampled_from([2048, 8192, 1 << 16]), channels=st.sampled_from([1, 2]))
@example(fields={"regularization_relative": 1e-12, "output_length_mode": "full_fft", "normalise_peak": False,
                 "remove_dc": False}, ir="noise", length=1 << 16, channels=2)
def test_deconvolve_settings_match_jax_and_the_oracle(wavs, fields, ir, length, channels):
    root = wavs["root"]
    recorded = _write(root / f"rec_{ir}_{length}_{channels}.wav",
                      parity_matrix.make_recorded(_irs()[ir][:length, :channels]))
    jax_settings = jdeconvolve.DeconvolveSettings(**fields)
    theirs = jdeconvolve.deconvolve_from_wav_files(recorded, wavs["sweep"], jax_settings, root / "theirs.wav")
    jax.clear_caches()
    ours = deconvolve.deconvolve_from_wav_files(recorded, wavs["sweep"], analyses.settings_from_jax(jax_settings),
                                                root / "ours.wav", device="cpu")
    assert ours.samples.shape == theirs.samples.shape and ours.samples.dtype == np.float32
    assert ours.samples.shape[1] == channels
    ref = _oracle_ir(recorded, wavs["sweep"], jax_settings)
    assert ref.shape == ours.samples.shape
    vs_jax, vs_f64 = DECONVOLVE_TOL[fields["regularization_relative"]]
    assert np.abs(ours.samples - theirs.samples).max() <= vs_jax * np.abs(theirs.samples).max(), fields
    assert np.abs(ours.samples - ref).max() <= vs_f64 * np.abs(ref).max(), fields
    a, b = (root / "ours.wav").read_bytes(), (root / "theirs.wav").read_bytes()
    assert len(a) == len(b) and a[: a.index(b"data") + 8] == b[: b.index(b"data") + 8]


# -------------------------------------------------------------------- ir ----

IR_VIEW = {
    "early_window_seconds": st.sampled_from([0.005, 0.08, 0.5]),
    "log_magnitude_floor_db": st.sampled_from([-140.0, -120.0, -60.0]),
    "use_mono_downmix": st.booleans(),
}


@DRAWS
@given(fields=st.fixed_dictionaries(IR_VIEW), ir=st.sampled_from(["noise", "modal", "damped"]),
       length=st.sampled_from([1000, 8192, 1 << 16]), channels=st.sampled_from([1, 2]))
def test_ir_view_settings_match_jax(wavs, tmp_path, fields, ir, length, channels):
    x = _irs()[ir][:length, :channels]
    path = _write(tmp_path / "ir.wav", x[:, 0] if channels == 1 else x)
    jax_settings = jimpulse.ImpulseResponseViewSettings(**fields)
    theirs = jimpulse.plot_ir_from_wav_file(path, jax_settings, None, show_interactive=False)
    ours = impulse_response.analyse_ir_from_wav_file(path, analyses.settings_from_jax(jax_settings))
    assert ours == theirs and len(ours["channels"]) == channels
    argv = ["ir", "--input", path, "--no_show", "--json", str(tmp_path / "ir.json"), "--device", "cpu",
            "--early-window", str(fields["early_window_seconds"]),
            "--floor-db", str(fields["log_magnitude_floor_db"])]
    with contextlib.redirect_stdout(io.StringIO()):
        cli_main(argv + (["--mono"] if fields["use_mono_downmix"] else []))
    assert json.loads((tmp_path / "ir.json").read_text()) == json.loads(json.dumps(theirs))


# ------------------------------------------------------------------- gen ----

def _flags(options: dict):
    """argv lists: each flag followed by a value drawn from its list."""
    return st.fixed_dictionaries({flag: st.sampled_from(values) for flag, values in options.items()}).map(
        lambda d: [x for flag, value in d.items() for x in (flag, str(value))])


def _gen(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def assert_gen_runs_agree(ours_dir, theirs_dir, ours: str, theirs: str) -> None:
    """The same stdout and WAV names; bytes equal but Karplus-Strong's,
    whose header is equal and samples within 1 LSB."""
    assert ours.replace(str(ours_dir), "D") == theirs.replace(str(theirs_dir), "D")
    names = sorted(p.name for p in theirs_dir.glob("*.wav"))
    assert names and sorted(p.name for p in ours_dir.glob("*.wav")) == names
    for name in names:
        a, b = (ours_dir / name).read_bytes(), (theirs_dir / name).read_bytes()
        if not name.startswith("karplus_pluck"):
            assert a == b, name
            continue
        assert len(a) == len(b) and a[: a.index(b"data") + 8] == b[: b.index(b"data") + 8]
        x, y = wavfile.read(ours_dir / name)[1], wavfile.read(theirs_dir / name)[1]
        assert np.abs(x.astype(np.int32) - y.astype(np.int32)).max() <= 1, name


@pytest.mark.parametrize("command", sorted(GEN_FLAGS))
def test_gen_signal_flags_match_jax(tmp_path_factory, command):
    @GEN_DRAWS
    @given(flags=_flags(GEN_FLAGS[command]), channel_mode=st.sampled_from(["mono", "stereo"]),
           rate=st.sampled_from([48_000, 44_100]))
    def run(flags, channel_mode, rate):
        root = tmp_path_factory.mktemp(command)
        ours_dir, theirs_dir = root / "ours", root / "theirs"
        common = ["--channel_mode", channel_mode, "--sample_rate_hz", str(rate)]
        ours = _gen(torch_gen.main, ["--output-dir", str(ours_dir), *common, "--device", "cpu", command, *flags])
        theirs = _gen(jax_gen.main, ["--output-dir", str(theirs_dir), *common, command, *flags])
        jax.clear_caches()
        assert_gen_runs_agree(ours_dir, theirs_dir, ours, theirs)

    run()


def test_every_gen_flag_is_drawn():
    """Each subcommand's drawn flags are all of its flags but --output."""
    sub = next(a for a in torch_gen.build_parser()._actions if a.dest == "command_name")
    assert sorted(sub.choices) == sorted([*GEN_FLAGS, "all"])
    for command, options in GEN_FLAGS.items():
        flags = {s for a in sub.choices[command]._actions for s in a.option_strings} - {"-h", "--help", "--output"}
        assert flags == set(options), command
