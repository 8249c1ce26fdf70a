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

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402

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
    root = _write_bench_bundle(tmp_path / "b", 2, 1 << 14)
    code = (
        "import sys\n"
        "from audio_analysis_tpu_torch.cli.analyse_cli import main\n"
        f"main(['bundle', '--input', {str(root)!r}, '--no-plots', '--device', 'cpu'])\n"
        "bad = [m for m in ('jax', 'matplotlib') if m in sys.modules]\n"
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
    assert (root / "reports" / "bundle_metrics.json").exists()


@pytest.mark.parametrize(
    "extra,flag",
    [
        ([], "--no-plots"),
        (["--no-plots", "--bands-decimate"], "--bands-decimate"),
        (["--no-plots", "--compare", "prev"], "--compare"),
        (["--no-plots", "--multi-host"], "--multi-host"),
        (["--no-plots", "--tap-shard", "0/2"], "--tap-shard"),
        (["--no-plots", "--resume"], "--resume"),
        (["--no-plots", "--plot-processes", "2"], "--plot-processes"),
    ],
)
def test_cli_refuses_flags_not_yet_ported(extra, flag):
    with pytest.raises(SystemExit) as exc:
        torch_cli_main(["bundle", "--input", "unused", "--device", "cpu"] + extra)
    message = str(exc.value.code)
    assert "not yet ported" in message and flag in message
