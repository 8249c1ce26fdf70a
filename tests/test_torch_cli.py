"""The port's CLI surface (audio_analysis_tpu_torch/cli/analyse_cli.py)
against the JAX CLI's engine-path and per-file subcommands, and `batch`
and `bundle --bands-decimate` end to end on the CPU against the JAX CLI.

- The port's parser has every subcommand of the JAX parser. Every option
  of the JAX parser's bundle, batch, watch and compare subcommands, of its
  per-file subcommands (ir, zplane, decay, rt60bands, fr, filter,
  groupdelay, spectrogram, diffusion, waterfall, modalcloud, deconvolve)
  and of `report`, parses in the port's parser to the same destination
  and value (so the same defaults), and is then either accepted or
  refused by the JAX CLI's own argument validation with its message;
  nothing is refused as "not yet ported". The port adds only `--device`.
- Without CUDA every subcommand that touches the device exits before any
  side effect unless `--device cpu` is given.
- bundle_metrics.json of `batch --no-plots` and of `bundle --no-plots
  --bands-decimate` agree with the JAX CLI's on the same inputs within the
  tolerances of tests/test_torch_bundle.py (integers and flags exact,
  floats 1e-4, per-bin modal fits 1e-2, group delay 1e-3 relative).
"""

import argparse
import json
from pathlib import Path
from unittest import mock

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from audio_analysis_tpu.cli import analyse_cli as jax_cli  # noqa: E402
from audio_analysis_tpu.io.bundle import materialize_bundle_view as jax_materialize  # noqa: E402
from audio_analysis_tpu_torch.cli import analyse_cli as torch_cli  # noqa: E402
from audio_analysis_tpu_torch.io import native, write_bundle  # noqa: E402
from audio_analysis_tpu_torch.io.wav import write_wav_pcm16  # noqa: E402
from test_torch_bundle import METRIC_RTOL, _write_bench_bundle  # noqa: E402

SR = 48_000

REQUIRED = {
    "bundle": ["--input", "unused", "--no-plots"],
    "batch": ["--inputs", "a.wav", "--output", "unused", "--no-plots"],
    "watch": ["--input", "unused"],
    "compare": ["prev", "cur"],
    "deconvolve": ["--recorded_wav_file_path", "r.wav", "--sweep_wav_file_path", "s.wav"],
    "groupdelay": ["--input", "x.wav", "--no-show"],
    "zplane": ["--input", "x.wav", "--no-show"],
    "report": ["--input", "x.wav", "--output", "unused"],
    **{
        command: ["--input", "x.wav", "--no_show"]
        for command in ("ir", "decay", "rt60bands", "fr", "filter", "spectrogram", "diffusion", "waterfall",
                        "modalcloud")
    },
}
VALUES = {"--tap-shard": ["0/2"], "--coordinator": ["host:1234"]}


def _subparser(parser: argparse.ArgumentParser, command: str) -> argparse.ArgumentParser:
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return sub.choices[command]


def _options(parser: argparse.ArgumentParser):
    return [a for a in parser._actions if a.option_strings and not isinstance(a, argparse._HelpAction)]


def _value(option: str, action: argparse.Action) -> list:
    if action.nargs == 0:
        return []
    if option in VALUES:
        return VALUES[option]
    if action.choices:
        return [list(action.choices)[-1]]
    if action.type is int:
        return ["2"]
    if action.type is float:
        return ["2.5"]
    return ["x.wav"]


@pytest.mark.parametrize("command", sorted(REQUIRED))
def test_port_parser_covers_the_jax_surface(command):
    jax_sub = _subparser(jax_cli.build_parser(), command)
    port_sub = _subparser(torch_cli.build_parser(), command)
    jax_opts = {o for a in _options(jax_sub) for o in a.option_strings}
    port_opts = {o for a in _options(port_sub) for o in a.option_strings}
    assert port_opts - jax_opts == ({"--device"} if command != "compare" else set())
    assert jax_opts <= port_opts
    device = ["--device", "cpu"] if command != "compare" else []
    for action in _options(jax_sub):
        for option in action.option_strings:
            argv = [command] + REQUIRED[command] + [option] + _value(option, action)
            ref = vars(jax_cli.build_parser().parse_args(argv))
            got = vars(torch_cli.build_parser().parse_args(argv + device))
            # the same destinations, values and defaults
            assert {k: got[k] for k in ref} == ref, option
            if command == "compare":
                continue
            args = argparse.Namespace(**got)
            try:
                torch_cli._check_args(command, args)
            except SystemExit as exc:
                with pytest.raises(SystemExit) as jax_exc:
                    jax_cli.main(argv)
                assert str(exc.code) == str(jax_exc.value.code), option


def test_port_parser_has_every_jax_subcommand():
    jax_sub = next(a for a in jax_cli.build_parser()._actions if isinstance(a, argparse._SubParsersAction))
    port_sub = next(a for a in torch_cli.build_parser()._actions if isinstance(a, argparse._SubParsersAction))
    assert sorted(port_sub.choices) == sorted(jax_sub.choices) == sorted(REQUIRED)


@pytest.mark.parametrize(
    "argv",
    [
        ["bundle", "--input", "unused", "--compare", "prev"],
        ["bundle", "--input", "unused", "--no-plots", "--resume"],
        ["bundle", "--input", "unused", "--no-plots", "--tap-shard", "0/2"],
        ["batch", "--inputs", "a.wav", "--output", "unused", "--compare", "prev"],
        ["batch", "--inputs", "a.wav", "--output", "unused", "--no-plots", "--resume"],
        ["bundle", "--input", "unused", "--multi-host", "--coordinator", "127.0.0.1:1", "--process-id", "0"],
    ],
    ids=["bundle-compare", "bundle-resume", "bundle-tap-shard", "batch-compare", "batch-resume",
         "multi-host-coordinator"],
)
def test_argument_validation_messages_match_jax(argv, tmp_path):
    argv = [str(tmp_path / a) if a == "unused" else a for a in argv]
    with pytest.raises(SystemExit) as ours:
        torch_cli.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as theirs:
        jax_cli.main(argv)
    assert ours.value.code == theirs.value.code and "not yet ported" not in str(ours.value.code)
    assert not (tmp_path / "unused").exists()  # refused before any side effect


@pytest.mark.parametrize("command", ["bundle", "batch", "watch"])
def test_without_cuda_the_device_commands_exit_unless_cpu(command, tmp_path):
    out = tmp_path / "out"
    argv = {
        "bundle": ["bundle", "--input", str(out), "--no-plots"],
        "batch": ["batch", "--inputs", str(tmp_path / "a.wav"), "--output", str(out), "--no-plots"],
        "watch": ["watch", "--input", str(out)],
    }[command]
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(SystemExit) as exc:
            torch_cli.main(argv)
    assert "CUDA is not available" in str(exc.value.code) and "--device cpu" in str(exc.value.code)
    assert not out.exists()


def _wav(path: Path, seed: int, n: int = 1 << 14, rate: int = SR) -> Path:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    x = np.zeros((n, 2), np.float32)
    x[64:] = 0.05 * rng.standard_normal((n - 64, 2)) * 10.0 ** (-3.0 * t[: n - 64, None] / (0.2 + 0.05 * seed))
    x[64] = 0.9
    write_wav_pcm16(path, x, rate)
    return path


def _assert_metrics_agree(ours_path: Path, theirs_path: Path) -> None:
    ours, theirs = json.loads(ours_path.read_text()), json.loads(theirs_path.read_text())
    assert ours["taps"] == theirs["taps"] and ours["channels"] == theirs["channels"]
    assert list(ours["metrics"]) == list(theirs["metrics"])
    for key, ref in theirs["metrics"].items():
        a, b = np.asarray(ours["metrics"][key]), np.asarray(ref)
        assert a.shape == b.shape and a.dtype == b.dtype, key
        if a.dtype != np.float64:
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            np.testing.assert_allclose(a, b, rtol=METRIC_RTOL.get(key, 1e-4), atol=1e-4, equal_nan=True, err_msg=key)


def test_batch_matches_jax_cli(tmp_path):
    """Three loose WAVs, two with the same stem: the bundle view (symlinked
    taps, `_2` suffix, "view": true) and the metrics of both CLIs."""
    from audio_analysis_tpu.io import native as jax_native

    assert native.ensure_built() == jax_native.ensure_built()  # one loader branch on both sides
    (tmp_path / "other").mkdir()
    wavs = [_wav(tmp_path / "hall.wav", 1), _wav(tmp_path / "plate.wav", 2), _wav(tmp_path / "other" / "hall.wav", 3)]
    inputs = [str(w) for w in wavs]
    torch_cli.main(["batch", "--inputs", *inputs, "--output", str(tmp_path / "ours"), "--no-plots", "--device", "cpu"])
    jax_cli.main(["batch", "--inputs", *inputs, "--output", str(tmp_path / "theirs"), "--no-plots"])
    meta = json.loads((tmp_path / "ours" / "meta.json").read_text())
    assert meta == json.loads((tmp_path / "theirs" / "meta.json").read_text())
    assert meta["taps"] == ["hall", "plate", "hall_2"] and meta["view"] is True
    assert (tmp_path / "ours" / "taps" / "hall_2.wav").resolve() == wavs[2].resolve()
    _assert_metrics_agree(
        tmp_path / "ours" / "reports" / "bundle_metrics.json",
        tmp_path / "theirs" / "reports" / "bundle_metrics.json",
    )
    # a second view over fewer inputs prunes the stale tap
    torch_cli.main(["batch", "--inputs", inputs[0], "--output", str(tmp_path / "ours"), "--no-plots", "--device", "cpu"])
    assert sorted(p.name for p in (tmp_path / "ours" / "taps").iterdir()) == ["hall.wav"]


@pytest.mark.parametrize("case", ["real_bundle", "mixed_rates", "missing_input"])
def test_batch_refusals_match_jax(case, tmp_path):
    out = tmp_path / "out"
    inputs = [_wav(tmp_path / "a.wav", 1)]
    if case == "real_bundle":
        write_bundle(out, {"tap": np.zeros((4096, 2), np.float32)}, SR)
    elif case == "mixed_rates":
        inputs.append(_wav(tmp_path / "b.wav", 2, rate=44_100))
    else:
        inputs.append(tmp_path / "absent.wav")
    argv = ["batch", "--inputs", *map(str, inputs), "--output", str(out), "--no-plots"]
    with pytest.raises(SystemExit) as ours:
        torch_cli.main(argv + ["--device", "cpu"])
    with pytest.raises(ValueError) as theirs:
        jax_materialize(inputs, out)
    assert ours.value.code == str(theirs.value)


def test_bundle_bands_decimate_matches_jax_cli(tmp_path):
    """`bundle --no-plots --bands-decimate` on three decaying-noise taps of
    2^16 samples (band factors (4, 4, 1)), through both CLIs."""
    root = _write_bench_bundle(tmp_path / "b", 3, 1 << 16)
    torch_cli.main(["bundle", "--input", str(root), "--no-plots", "--bands-decimate", "--device", "cpu"])
    jax_cli.main(["bundle", "--input", str(root), "--no-plots", "--bands-decimate", "--reports-subdir", "reports_jax"])
    _assert_metrics_agree(root / "reports" / "bundle_metrics.json", root / "reports_jax" / "bundle_metrics.json")
