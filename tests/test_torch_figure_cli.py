"""The figures of the port's analyse CLI on the CPU against the JAX CLI,
on the golden IR (tests/golden_utils.make_golden_ir):

- --output of every per-file command (and its renderer and style
  options) writes the same files as the JAX CLI, PNG names included;
- `report` prints the report's markdown and "Wrote: <markdown>", the
  markdown within golden_utils.compare_reports of the JAX CLI's, the
  --timing footer included; --profile-dir writes a Chrome trace;
- where matplotlib does not import, a command that draws exits before any
  work with a message naming it, and the same analysis without figures
  still runs;
- each module's `plot_*_from_wav_file` writes the JAX function's PNG names
  and returns results of the same type.
"""

import importlib
import sys
from unittest import mock

import pytest

pytest.importorskip("jax")
pytest.importorskip("matplotlib")

import torch  # noqa: E402

import golden_utils  # noqa: E402
from audio_analysis_tpu.cli import analyse_cli as jax_cli  # noqa: E402
from audio_analysis_tpu_torch.cli import analyse_cli as torch_cli  # noqa: E402
from test_torch_analyses import _write  # noqa: E402
from test_torch_per_file_cli import _figure_files, _stdout  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def golden_wav(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("figure_cli") / "golden.wav", golden_utils.make_golden_ir())


@pytest.mark.parametrize(
    "argv",
    [
        ["rt60bands", "--no_show", "--output", "plots/x"],
        ["rt60bands", "--no_show", "--band_mode", "octave", "--output", "plots/x"],
        ["fr", "--no_show", "--output", "plots/x"],
        ["groupdelay", "--no-show", "--output", "plots/x"],
        ["spectrogram", "--no_show", "--renderer", "quadmesh", "--output", "plots/x"],
        ["diffusion", "--no_show", "--output", "plots/x"],
        ["waterfall", "--no_show", "--output", "plots/x"],
        ["waterfall", "--no_show", "--style", "2d", "--output", "plots/x"],
        ["modalcloud", "--no_show", "--output", "plots/x"],
        ["filter", "--no_show", "--output", "plots/x"],
        ["zplane", "--no-show", "--ar-order", "16", "--zeros", "--output", "plots/x"],
    ],
    ids=["rt60bands", "rt60bands-octave", "fr", "groupdelay", "spectrogram-quadmesh", "diffusion", "waterfall",
         "waterfall-2d", "modalcloud", "filter", "zplane-zeros"],
)
def test_output_writes_the_jax_png_names(golden_wav, tmp_path, argv):
    ours = _figure_files(tmp_path, golden_wav, argv, "ours")
    assert ours == _figure_files(tmp_path, golden_wav, argv, "theirs")
    assert any(name.endswith(".png") for name in ours)
    for name in ours:
        if name.endswith(".png"):
            assert (tmp_path / "ours" / name).stat().st_size > 1000, name


def test_report_stdout_matches_jax_cli(golden_wav, tmp_path, capsys):
    """`report` prints the report's markdown, then "Wrote: <markdown>"; the
    markdown agrees with the JAX CLI's (golden_utils.compare_reports), the
    --timing footer included."""
    argv = ["report", "--input", golden_wav, "--timing", "--output"]
    profile = ["--profile-dir", str(tmp_path / "trace")]
    ours = _stdout(capsys, torch_cli.main, argv + [str(tmp_path / "ours" / "x"), "--device", "cpu", *profile])
    theirs = _stdout(capsys, jax_cli.main, argv + [str(tmp_path / "theirs" / "x")])
    assert ours.splitlines()[-1] == f"Wrote: {tmp_path / 'ours' / 'x_report.md'}"
    golden_utils.compare_reports(theirs.rsplit("Wrote:", 1)[0], ours.rsplit("Wrote:", 1)[0])
    assert "## Timing" in ours and (tmp_path / "ours" / "x_report.md").read_text() in ours
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert sorted(q.name for q in (tmp_path / "ours").iterdir()) == sorted(q.name for q in (tmp_path / "theirs").iterdir())


@pytest.mark.parametrize(
    "argv",
    [
        ["report", "--output", "plots/x"],
        ["decay", "--no_show", "--output", "plots/x"],
        ["spectrogram"],
    ],
    ids=["report", "decay-output", "spectrogram-show"],
)
def test_figures_without_matplotlib_exit_before_any_work(golden_wav, tmp_path, capsys, argv):
    """Where matplotlib does not import, a command that draws exits with a
    message naming it and writes nothing; the same analysis without
    figures still runs."""
    args = [a.replace("plots/x", str(tmp_path / "x")) for a in argv[1:]]
    with mock.patch.dict(sys.modules, {"matplotlib": None}):
        with pytest.raises(SystemExit) as exc:
            torch_cli.main([argv[0], "--input", golden_wav, *args, "--device", "cpu"])
        assert "matplotlib" in str(exc.value.code)
        assert list(tmp_path.iterdir()) == []
        if argv[0] != "report":
            out = _stdout(capsys, torch_cli.main, [argv[0], "--input", golden_wav, "--no_show", "--device", "cpu"])
            assert out.startswith("[left]")


@pytest.mark.parametrize(
    "module,function",
    [
        ("decay", "plot_decay_from_wav_file"),
        ("rt60bands", "plot_rt60_bands_from_wav_file"),
        ("frequency_response", "plot_frequency_response_from_wav_file"),
        ("group_delay", "plot_group_delay_from_wav_file"),
        ("spectrogram", "plot_spectrogram_from_wav_file"),
        ("diffusion", "plot_diffusion_from_wav_file"),
        ("waterfall", "plot_waterfall_from_wav_file"),
        ("modalcloud", "plot_modal_cloud_from_wav_file"),
        ("filterplot", "plot_filter_response_from_wav_file"),
        ("zplane", "plot_zplane_from_wav_file"),
        ("impulse_response", "plot_ir_from_wav_file"),
    ],
)
def test_plot_from_wav_file_writes_the_jax_png_names(golden_wav, tmp_path, module, function):
    names = {}
    for side, package, extra in (("ours", "audio_analysis_tpu_torch", {"device": "cpu"}),
                                 ("theirs", "audio_analysis_tpu", {})):
        plot_fn = getattr(importlib.import_module(f"{package}.analyses.{module}"), function)
        if module == "impulse_response":
            extra = {}
        elif module == "zplane":
            zplane = importlib.import_module(f"{package}.analyses.zplane")
            extra = {**extra, "settings": zplane.ZPlaneAnalysisSettings(ar_order=16)}
        results = plot_fn(golden_wav, output_basename=tmp_path / side / "x", show_interactive=False, **extra)
        names[side] = (sorted(q.name for q in (tmp_path / side).iterdir()), type(results).__name__)
    assert names["ours"] == names["theirs"] and names["ours"][0]
