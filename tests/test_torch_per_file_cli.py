"""The port's per-file subcommands (ir, zplane, decay, rt60bands, fr,
filter, groupdelay, spectrogram, diffusion, waterfall, modalcloud,
deconvolve; fr, filter and groupdelay also with --exact-grid) through its
CLI entry on the CPU, against the JAX CLI on the same files.

- stdout: the JAX CLI's lines ("Wrote JSON: <path>", then the summary;
  `ir` prints only the first) with the same structure and every number
  within the module's tolerance of tests/test_reference_parity.py
  (TOLERANCES, EXACT_TOLERANCES for --exact-grid; the z-plane at order 32
  within tests/parity_matrix.py's order-16 tolerance); `deconvolve` prints
  the JAX CLI's lines exactly, and writes a WAV with the JAX one's header.
- --json: the same keys and leaf types as the JAX CLI's file.
- The figures: --output writes the JAX CLI's files (and `report` its
  markdown and PNGs); a run without --no_show / --no-show draws and shows,
  a no-op under the headless backend (more in
  tests/test_torch_figure_cli.py). Without CUDA, every per-file command
  exits unless --device cpu is given.
"""

import json
from unittest import mock

import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import golden_utils  # noqa: E402
import parity_matrix  # noqa: E402
from _summary_parity import assert_summaries_agree, json_skeleton  # noqa: E402
from audio_analysis_tpu.cli import analyse_cli as jax_cli  # noqa: E402
from audio_analysis_tpu_torch.cli import analyse_cli as torch_cli  # noqa: E402
from test_reference_parity import EXACT_TOLERANCES, TOLERANCES  # noqa: E402
from test_torch_analyses import _write  # noqa: E402

torch.set_num_threads(2)

# (id, argv after the input, module of the tolerance)
CASES = [
    ("decay", ["decay", "--no_show"], "decay"),
    ("decay_smoothing_480", ["decay", "--no_show", "--smoothing", "480"], "decay"),
    ("rt60bands", ["rt60bands", "--no_show"], "rt60bands"),
    ("rt60bands_octave", ["rt60bands", "--no_show", "--band_mode", "octave", "--include_t20"], "rt60bands"),
    ("rt60bands_third", ["rt60bands", "--no_show", "--band_mode", "third"], "rt60bands"),
    ("fr", ["fr", "--no_show"], "frequency_response"),
    ("fr_smoothed", ["fr", "--no_show", "--smoothing_log_bins", "9"], "frequency_response"),
    ("groupdelay", ["groupdelay", "--no-show"], "group_delay"),
    ("spectrogram", ["spectrogram", "--no_show"], "spectrogram"),
    ("spectrogram_n_fft_3000", ["spectrogram", "--no_show", "--n_fft", "3000"], "spectrogram"),
    ("diffusion", ["diffusion", "--no_show"], "diffusion"),
    ("waterfall", ["waterfall", "--no_show"], "waterfall"),
    ("modalcloud", ["modalcloud", "--no_show"], "modalcloud"),
    ("modalcloud_n_fft_32768", ["modalcloud", "--no_show", "--n_fft", "32768"], "modalcloud"),
    ("filter", ["filter", "--no_show"], "filterplot"),
    ("zplane_order_32", ["zplane", "--no-show", "--ar-order", "32"], "zplane"),
    ("ir", ["ir", "--no_show"], "ir"),
    ("fr_exact_grid", ["fr", "--no_show", "--exact-grid"], "exact_frequency_response"),
    ("groupdelay_exact_grid", ["groupdelay", "--no-show", "--exact-grid"], "exact_group_delay"),
    ("filter_exact_grid", ["filter", "--no_show", "--exact-grid"], "exact_filterplot"),
]
CASE_TOLERANCES = {
    **TOLERANCES,
    **{"exact_" + module: tol for module, tol in EXACT_TOLERANCES.items()},
    "zplane": (2e-2, 5e-3),
    "ir": (0.0, 0.0),  # no summary: the JSON line alone
}


@pytest.fixture(scope="module")
def golden_wav(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("per_file_cli") / "golden.wav", golden_utils.make_golden_ir())


def _stdout(capsys, main, argv) -> str:
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("argv,module", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_per_file_stdout_and_json_match_jax_cli(golden_wav, tmp_path, capsys, argv, module):
    ours_json, theirs_json = tmp_path / "ours.json", tmp_path / "theirs.json"
    cmd = [argv[0], "--input", golden_wav, *argv[1:]]
    ours = _stdout(capsys, torch_cli.main, cmd + ["--json", str(ours_json), "--device", "cpu"])
    theirs = _stdout(capsys, jax_cli.main, cmd + ["--json", str(theirs_json)])
    assert ours.splitlines()[0] == f"Wrote JSON: {ours_json}"
    assert theirs.splitlines()[0] == f"Wrote JSON: {theirs_json}"
    rel, abs_ = CASE_TOLERANCES[module]
    assert_summaries_agree(theirs.split("\n", 1)[1], ours.split("\n", 1)[1], rel, abs_, argv[0])
    assert ours.endswith("\n") and ours.count("\n") == theirs.count("\n")
    assert json_skeleton(json.loads(ours_json.read_text())) == json_skeleton(json.loads(theirs_json.read_text()))


def test_deconvolve_cli_matches_jax_cli(tmp_path, capsys):
    sweep = _write(tmp_path / "sweep.wav", parity_matrix.make_sweep())
    recorded = _write(tmp_path / "rec.wav", parity_matrix.make_recorded(golden_utils.make_golden_ir()))
    base = ["deconvolve", "--recorded_wav_file_path", recorded, "--sweep_wav_file_path", sweep,
            "--no-normalise_peak", "--output_length_mode", "full_fft"]
    ours_wav, theirs_wav = tmp_path / "ours_ir.wav", tmp_path / "theirs_ir.wav"
    ours = _stdout(capsys, torch_cli.main, base + ["--output_ir_wav_file_path", str(ours_wav), "--device", "cpu"])
    theirs = _stdout(capsys, jax_cli.main, base + ["--output_ir_wav_file_path", str(theirs_wav)])
    assert ours.replace(str(ours_wav), "IR") == theirs.replace(str(theirs_wav), "IR")
    assert ours.splitlines()[1:] == ["  sample_rate_hz=48000", "  channels=2", "  length_seconds=2.731"]
    a, b = ours_wav.read_bytes(), theirs_wav.read_bytes()
    assert len(a) == len(b) and a[: a.index(b"data") + 8] == b[: b.index(b"data") + 8]
    # without an output path: <recorded stem>_ir.wav beside the recording
    out = _stdout(capsys, torch_cli.main, base[:5] + ["--device", "cpu"])
    assert out.splitlines()[0] == f"Wrote IR WAV: {tmp_path / 'rec_ir.wav'}"
    assert (tmp_path / "rec_ir.wav").is_file()


def _figure_files(tmp_path, golden_wav, argv, side: str) -> list:
    """Run one CLI (`side` "ours": the port on the CPU, "theirs": the JAX
    CLI) with `plots/x` in argv pointing into its own directory; the names
    of the files it wrote there."""
    main, extra = (torch_cli.main, ["--device", "cpu"]) if side == "ours" else (jax_cli.main, [])
    out = tmp_path / side
    out.mkdir()
    args = [a.replace("plots/x", str(out / "x")) for a in argv[1:]]
    json_flag = [] if argv[0] == "report" else ["--json", str(out / "out.json")]  # report has no --json
    main([argv[0], "--input", golden_wav, *args, *json_flag, *extra])
    return sorted(q.name for q in out.iterdir())


@pytest.mark.parametrize(
    "argv,flag",
    [
        (["decay", "--no_show", "--output", "plots/x"], "--output"),
        (["spectrogram", "--no_show", "--output", "plots/x"], "--output"),
        (["decay"], "--no_show"),
        (["waterfall"], "--no_show"),
        (["groupdelay"], "--no-show"),
        (["filter", "--no_show", "--exact-grid", "--output", "plots/x"], "--output"),
        (["zplane", "--ar-order", "16"], "--no-show"),
        (["ir", "--no_show", "--output", "plots/x"], "--output"),
        (["report", "--output", "plots/x", "--no-ir"], "report"),
    ],
    ids=["decay-output", "spectrogram-output", "decay-show", "waterfall-show", "groupdelay-show",
         "filter-output", "zplane-show", "ir-output", "report"],
)
def test_per_file_figures_and_exact_grid_are_refused(golden_wav, tmp_path, argv, flag):
    """These figure paths were refused as not yet ported; they now run (the
    test keeps its name). With --output (and `report`) the port writes the
    files the JAX CLI writes, PNG names included; without --no_show /
    --no-show it draws and shows, a no-op under the headless backend, and
    writes only the JSON, as the JAX CLI does."""
    ours = _figure_files(tmp_path, golden_wav, argv, "ours")
    assert ours == _figure_files(tmp_path, golden_wav, argv, "theirs")
    if flag in ("--output", "report"):
        assert any(name.endswith(".png") for name in ours)
    else:
        assert ours == ["out.json"]


@pytest.mark.parametrize("command", ["decay", "modalcloud", "deconvolve", "zplane", "filter", "ir"])
def test_without_cuda_the_per_file_commands_exit_unless_cpu(golden_wav, tmp_path, command):
    argv = {
        "decay": ["decay", "--input", golden_wav, "--no_show"],
        "modalcloud": ["modalcloud", "--input", golden_wav, "--no_show"],
        "zplane": ["zplane", "--input", golden_wav, "--no-show", "--ar-order", "16"],
        "filter": ["filter", "--input", golden_wav, "--no_show", "--exact-grid"],
        "ir": ["ir", "--input", golden_wav, "--no_show"],
        "deconvolve": ["deconvolve", "--recorded_wav_file_path", golden_wav, "--sweep_wav_file_path", golden_wav,
                       "--output_ir_wav_file_path", str(tmp_path / "ir.wav")],
    }[command]
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(SystemExit) as exc:
            torch_cli.main(argv)
    assert "CUDA is not available" in str(exc.value.code)
    assert not (tmp_path / "ir.wav").exists()
