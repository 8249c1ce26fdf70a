"""End to end: a bundle from io.write_bundle goes through the port's CLI
(`python -m audio_analysis_tpu_torch.cli bundle --no-plots`, plain torch
versions on the CPU) and through the JAX package's
run_bundle_report_engine. The per-tap markdown must agree line by line by
skeleton, with numbers within the rule of
tests/test_engine_summary_equivalence.py (2 units of the printed precision
plus 2e-3 relative), and bundle_metrics.json must have the same keys,
shapes and values within the tolerances of tests/test_torch_engine.py.

Taps are decaying noise (bench.py's recipe: rt60 0.9..1.6 s), where every
metric, group delay included, is well conditioned.
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from audio_analysis_tpu.io.bundle import write_bundle  # noqa: E402
from audio_analysis_tpu_torch.cli.analyse_cli import main as torch_cli_main  # noqa: E402
from test_engine_summary_equivalence import (  # noqa: E402
    _assert_numbers_close,
    _skeleton_and_numbers,
)

REPO = Path(__file__).resolve().parents[1]
SR = 48_000
N = 1 << 16
TAPS = 4

METRIC_RTOL = {"modal_rt60": 1e-2, "modal_r2": 1e-2, "gd_p10": 1e-3, "gd_median": 1e-3, "gd_p90": 1e-3}


def _write_bench_bundle(root: Path, taps: int, n: int) -> Path:
    rng = np.random.default_rng(7)
    t = np.arange(n) / SR
    data = {}
    for i in range(taps):
        rt60 = 0.9 + 0.7 * (i / max(1, taps - 1))
        env = (10.0 ** (-3.0 * t / rt60)).astype(np.float32)
        x = np.zeros((n, 2), np.float32)
        x[256:, :] = 0.05 * rng.standard_normal((n - 256, 2)).astype(np.float32) * env[: n - 256, None]
        x[256, :] = 0.9
        data[f"tap{i:02d}"] = x
    return write_bundle(root, data, SR)


def _run_jax(root: Path, subdir: str, mono: bool) -> Path:
    from audio_analysis_tpu.report import EngineBundleSettings, run_bundle_report_engine

    settings = EngineBundleSettings(
        reports_subdir=subdir, use_mono_downmix_for_stereo=mono, use_device_mesh="off"
    )
    return run_bundle_report_engine(root, settings).parent


@pytest.fixture(scope="module", params=["stereo", "mono"])
def reports(request, tmp_path_factory):
    # both sides take the same loader branch: the pipelined PCM16 path when
    # the native decoder is built (make -C cpp), the float32 batch otherwise.
    # Each binding remembers its first load attempt for the life of the
    # process, so both are (re)tried here, after any build that happened
    # since this process first looked.
    from audio_analysis_tpu.io import native as jax_native
    from audio_analysis_tpu_torch.io import native as torch_native

    assert torch_native.ensure_built() == jax_native.ensure_built()
    root = _write_bench_bundle(tmp_path_factory.mktemp("bundle"), TAPS, N)
    mono = request.param == "mono"
    args = ["bundle", "--input", str(root), "--no-plots", "--device", "cpu",
            "--reports-subdir", "reports_torch"]
    torch_cli_main(args + (["--mono"] if mono else []))
    return _run_jax(root, "reports_jax", mono), root / "reports_torch"


def test_tap_markdown_agrees_line_by_line(reports):
    jax_dir, torch_dir = reports
    for i in range(TAPS):
        tap = f"tap{i:02d}"
        ours = (torch_dir / tap / f"{tap}_report.md").read_text().splitlines()
        theirs = (jax_dir / tap / f"{tap}_report.md").read_text().splitlines()
        assert len(ours) == len(theirs), tap
        for a, b in zip(ours, theirs):
            skel_a, num_a = _skeleton_and_numbers(a)
            skel_b, num_b = _skeleton_and_numbers(b)
            assert skel_a == skel_b, (tap, a, b)
            _assert_numbers_close(num_a, num_b, where=f"{tap}: {a!r} vs {b!r}")


def test_bundle_metrics_json_agrees(reports):
    jax_dir, torch_dir = reports
    ours = json.loads((torch_dir / "bundle_metrics.json").read_text())
    theirs = json.loads((jax_dir / "bundle_metrics.json").read_text())
    assert ours.keys() == theirs.keys()
    assert ours["taps"] == theirs["taps"] and ours["channels"] == theirs["channels"]
    assert ours["phases"].keys() == theirs["phases"].keys()
    np.testing.assert_allclose(ours["bundle_median_t30"], theirs["bundle_median_t30"], rtol=1e-4)
    assert list(ours["metrics"]) == list(theirs["metrics"])
    for key, ref in theirs["metrics"].items():
        a, b = np.asarray(ours["metrics"][key]), np.asarray(ref)
        assert a.shape == b.shape and a.dtype == b.dtype, key
        if a.dtype != np.float64:
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            np.testing.assert_allclose(
                a, b, rtol=METRIC_RTOL.get(key, 1e-4), atol=1e-4, equal_nan=True, err_msg=key
            )
    index = (torch_dir / "bundle_report.md").read_text()
    assert all(f"- [tap{i:02d}](tap{i:02d}/tap{i:02d}_report.md)" in index for i in range(TAPS))


def test_cli_path_imports_neither_jax_nor_matplotlib(tmp_path):
    """The bundle path and a per-file subcommand (with every analysis
    module, the report suite, the plot bundle runner and the plot workers
    imported) load neither jax, matplotlib nor the JAX package: the figure
    functions import matplotlib inside themselves."""
    root = _write_bench_bundle(tmp_path / "b", 2, 1 << 14)
    tap = root / "taps" / "tap00.wav"
    code = (
        "import sys\n"
        "import audio_analysis_tpu_torch.analyses\n"
        "import audio_analysis_tpu_torch.report.bundle, audio_analysis_tpu_torch.report.warmup\n"
        "import audio_analysis_tpu_torch.parallel.procpool\n"
        "from audio_analysis_tpu_torch.cli.analyse_cli import main\n"
        f"main(['bundle', '--input', {str(root)!r}, '--no-plots', '--device', 'cpu'])\n"
        f"main(['decay', '--input', {str(tap)!r}, '--no_show', '--device', 'cpu'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'matplotlib', 'audio_analysis_tpu')]\n"
        "assert not bad, bad\n"
        "print('CLEAN')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "Wrote bundle report index:" in proc.stdout and "CLEAN" in proc.stdout
    assert "[left] analysis_start_sample_index=" in proc.stdout
    assert (root / "reports" / "bundle_metrics.json").exists()


@pytest.mark.parametrize(
    "argv,flag",
    [
        (["bundle", "--input", "unused"], "--no-plots"),
        (["bundle", "--input", "unused", "--no-plots", "--multi-host"], "--multi-host"),
        (["bundle", "--input", "unused", "--no-plots", "--coordinator", "h:1"], "--coordinator"),
        (["bundle", "--input", "unused", "--tap-shard", "0/2"], "--tap-shard"),
        (["bundle", "--input", "unused", "--resume"], "--resume"),
        (["bundle", "--input", "unused", "--no-plots", "--plot-processes", "2"], "--plot-processes"),
        (["batch", "--inputs", "a.wav", "--output", "unused"], "--no-plots"),
        (["watch", "--input", "unused", "--plots"], "--plots"),
        (["watch", "--input", "unused", "--plot-processes", "2"], "--plot-processes"),
    ],
)
def test_cli_refuses_flags_not_yet_ported(argv, flag):
    """No flag is refused as "not yet ported" any more. `--multi-host`
    reaches the multi-host report writer (one process alone: no
    coordinator, no torchrun environment) on this process's device;
    `--coordinator` without `--multi-host` is ignored, as the JAX CLI
    ignores it. The plot paths: `bundle` / `batch` without --no-plots,
    with --tap-shard or --resume, reach the plot bundle runner with those
    settings, and `watch --plots` the watcher with plots on;
    `--plot-processes` on the paths that draw nothing (`bundle
    --no-plots`, `watch` without `--plots`) is accepted and ignored, as
    the JAX CLI does."""
    if argv[0] == "watch":
        target = "audio_analysis_tpu_torch.report.watch.watch_bundle_runs"
    elif flag == "--multi-host":
        target = "audio_analysis_tpu_torch.engine.distributed.run_bundle_report_multi_host"
    elif "--no-plots" in argv:
        target = "audio_analysis_tpu_torch.cli.analyse_cli.run_bundle_report_engine"
    else:
        target = "audio_analysis_tpu_torch.report.bundle.run_bundle_report"
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "WORLD_SIZE")}
    with mock.patch(target, return_value=Path("index.md")) as runner, \
            mock.patch("audio_analysis_tpu_torch.io.materialize_bundle_view", return_value=Path("unused")), \
            mock.patch.dict(os.environ, env, clear=True):
        torch_cli_main(argv + ["--device", "cpu"])
    assert runner.call_count == 1
    if argv[0] == "watch":
        assert runner.call_args.args[1].plots == ("--plots" in argv)
    if target.endswith(".run_bundle_report"):
        settings = runner.call_args.kwargs["settings"]
        assert settings.resume == ("--resume" in argv)
        assert settings.tap_shard == ("0/2" if "--tap-shard" in argv else None)
    if flag == "--multi-host":
        assert runner.call_args.kwargs["devices"] == [torch.device("cpu")]
