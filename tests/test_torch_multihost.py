"""The port's multi-host job (audio_analysis_tpu_torch/engine/distributed.py
and `bundle --multi-host`) in real two-process CPU jobs over gloo, against
the JAX package's two-process job.

- The port's CLI (`--device cpu`, no CUDA device visible, one device a
  rank) and the JAX CLI (one virtual CPU device a process, so both jobs
  have 2 global devices and the same tap ownership) on copies of one
  6-tap bundle of decaying noise (16,384 samples): the index markdown but
  its bundle-path line, every tap's markdown within the engine rule of
  tests/test_engine_summary_equivalence.py, and bundle_metrics.json
  (integers and flags exact, floats 1e-4, per-bin modal fits 1e-2, group
  delay 1e-3 relative). Only rank 0 prints the index line.
- tests/_torch_mh_worker.py on two ranks of two CPU devices each (4
  global devices: rank 0 owns taps 0-3, rank 1 taps 4-5 and the two
  padded rows, as in the JAX job of tests/test_distributed_multihost.py):
  identical aggregates on both ranks, the median equal to numpy's median
  of the per-tap T30s, and an in-place --compare that flags nothing.
- A tap at another sample rate raises the same error on both ranks.
- A bundle of one tap on two ranks of one device each: rank 1 owns no tap,
  runs no engine work, and still joins the gathers and the barrier; both
  ranks hold the same aggregates, and rank 0 writes the index.

Every rank runs with a timeout; survivors are killed and both output
pipes are drained at once.
"""

import concurrent.futures
import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import _mh_harness as mh  # noqa: E402
from audio_analysis_tpu.io.wav import write_wav_pcm16  # noqa: E402
from test_engine_summary_equivalence import _assert_numbers_close, _skeleton_and_numbers  # noqa: E402
from test_torch_bundle import METRIC_RTOL  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "_torch_mh_worker.py"
TAP_RT60S = [0.15, 0.18, 0.21, 0.24, 0.27, 0.30]
RANK_TIMEOUT_S = 240


def _free_address() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _port_env() -> dict:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [env.get("PYTHONPATH", ""), str(REPO)]))
    return env


def _run_ranks(commands, env) -> list:
    """Start every rank, drain all output pipes at once, kill whatever is
    still running after RANK_TIMEOUT_S; (exit code, output) per rank."""
    procs = [
        subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for cmd in commands
    ]
    try:
        with concurrent.futures.ThreadPoolExecutor(len(procs)) as pool:
            futures = [pool.submit(p.communicate, timeout=RANK_TIMEOUT_S) for p in procs]
            concurrent.futures.wait(futures)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    logs = []
    for p, f in zip(procs, futures):
        logs.append(f.result()[0].decode(errors="replace") if f.exception() is None else "rank timed out")
    return [(p.returncode, log) for p, log in zip(procs, logs)]


def _assert_ok(results, what: str) -> list:
    for code, log in results:
        assert code == 0, f"{what} failed ({code}):\n{log[-4000:]}"
    return [log for _code, log in results]


def _cli(module: str, bundle: Path, address: str, rank: int, *extra: str) -> list:
    return [sys.executable, "-m", module, "bundle", "--input", str(bundle), "--multi-host",
            "--coordinator", address, "--num-processes", "2", "--process-id", str(rank), *extra]


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_mh")
    names = mh.make_synthetic_bundle(root / "theirs", TAP_RT60S)
    shutil.copytree(root / "theirs", root / "ours")
    address = _free_address()
    logs = _assert_ok(_run_ranks(
        [_cli("audio_analysis_tpu_torch.cli", root / "ours", address, i, "--device", "cpu") for i in range(2)],
        _port_env(),
    ), "port CLI rank")
    address = _free_address()
    _assert_ok(_run_ranks(
        [_cli("analyse.cli", root / "theirs", address, i) for i in range(2)],
        mh.cpu_multihost_env(devices_per_process=1),
    ), "JAX CLI process")
    return names, root / "ours" / "reports", root / "theirs" / "reports", logs


def _assert_markdown_close(ours: str, theirs: str, where: str) -> None:
    a, b = ours.splitlines(), theirs.splitlines()
    assert len(a) == len(b), where
    for x, y in zip(a, b):
        skel_x, num_x = _skeleton_and_numbers(x)
        skel_y, num_y = _skeleton_and_numbers(y)
        assert skel_x == skel_y, (where, x, y)
        _assert_numbers_close(num_x, num_y, where=f"{where}: {x!r} vs {y!r}")


def test_index_matches_jax_and_rank_zero_prints_it(jobs):
    _names, ours, theirs, logs = jobs
    drop_bundle = lambda text: "\n".join(l for l in text.splitlines() if not l.startswith("**Bundle:**"))  # noqa: E731
    ours_md, theirs_md = (ours / "bundle_report.md").read_text(), (theirs / "bundle_report.md").read_text()
    assert "**Taps:** 6 over 2 process(es) / 2 device(s)" in ours_md
    _assert_markdown_close(drop_bundle(ours_md), drop_bundle(theirs_md), "index")
    assert ["Wrote bundle report index:" in log for log in logs] == [True, False]


def test_tap_markdown_matches_jax(jobs):
    names, ours, theirs, _logs = jobs
    for i, tap in enumerate(names):
        md = (ours / tap / f"{tap}_report.md").read_text()
        assert f"**Analysed by process:** {i // 3}" in md  # 2 devices: 3 taps a rank
        _assert_markdown_close(md, (theirs / tap / f"{tap}_report.md").read_text(), tap)


def test_bundle_metrics_match_jax(jobs):
    _names, ours, theirs, _logs = jobs
    a_text = (ours / "bundle_metrics.json").read_text()
    a, b = json.loads(a_text), json.loads((theirs / "bundle_metrics.json").read_text())
    assert a_text.startswith('{\n "taps"') and list(a) == list(b) == ["taps", "channels", "metrics"]
    assert a["taps"] == b["taps"] and a["channels"] == b["channels"]
    assert list(a["metrics"]) == list(b["metrics"])
    for key, ref in b["metrics"].items():
        x, y = np.asarray(a["metrics"][key]), np.asarray(ref)
        assert x.shape == y.shape and x.dtype == y.dtype, key
        if x.dtype != np.float64:
            np.testing.assert_array_equal(x, y, err_msg=key)
        else:
            np.testing.assert_allclose(x, y, rtol=METRIC_RTOL.get(key, 1e-4), atol=1e-4, equal_nan=True, err_msg=key)


def _worker_job(bundle: Path, out_dir: Path, mode: str) -> list:
    address = _free_address()
    outs = [out_dir / f"rank{i}.json" for i in range(2)]
    _assert_ok(_run_ranks(
        [[sys.executable, str(WORKER), address, "2", str(i), str(bundle), str(outs[i]), mode] for i in range(2)],
        _port_env(),
    ), f"{mode} worker")
    return [json.loads(p.read_text()) for p in outs]


def test_worker_ownership_aggregates_and_compare(tmp_path):
    names = mh.make_synthetic_bundle(tmp_path / "bundle", TAP_RT60S)
    results = _worker_job(tmp_path / "bundle", tmp_path, "analyze")
    # 4 global devices, 6 taps -> 8 rows, 2 a device: rank 0 owns taps 0-3,
    # rank 1 taps 4-5 (its two padded rows dropped)
    assert [r["num_devices"] for r in results] == [4, 4]
    assert results[0]["local_tap_names"] == names[:4] and results[1]["local_tap_names"] == names[4:]
    t30 = []
    for r in results:
        assert np.all(r["t30_ok"])
        t30 += [v for row in r["t30_rt60"] for v in row]
    for key in ("bundle_median_t30", "bundle_mean_early10", "bundle_valid_taps"):
        assert results[0][key] == results[1][key], key
    assert results[0]["bundle_valid_taps"] == len(TAP_RT60S)
    assert results[0]["bundle_median_t30"] == pytest.approx(float(np.median(t30)), rel=1e-3)
    index = (tmp_path / "bundle" / "reports" / "bundle_report.md").read_text()
    assert f"bundle_median_t30:** {float(np.median(t30)):.4f}" in index
    assert "**Taps:** 6 over 2 process(es) / 4 device(s)" in index


def test_wrong_rate_tap_raises_on_both_ranks(tmp_path):
    mh.make_synthetic_bundle(tmp_path / "bundle", TAP_RT60S[:3])
    write_wav_pcm16(tmp_path / "bundle" / "taps" / "tap01.wav", np.zeros((4096, 2), np.float32), 44_100)
    results = _worker_job(tmp_path / "bundle", tmp_path, "wrong_rate")
    for r in results:
        assert "tap01.wav sample rate 44100 != bundle 48000" in r["error"], r


def test_rank_without_taps(tmp_path):
    names = mh.make_synthetic_bundle(tmp_path / "bundle", TAP_RT60S[:1])
    results = _worker_job(tmp_path / "bundle", tmp_path, "one_device")
    assert results[0]["local_tap_names"] == names and results[1]["local_tap_names"] == []
    for key in ("global_t30_rt60", "bundle_median_t30", "bundle_valid_taps"):
        assert results[0][key] == results[1][key], key
    assert results[0]["bundle_valid_taps"] == 1
    t30 = np.asarray(results[0]["global_t30_rt60"])
    assert t30.shape == (1, 2)
    assert results[0]["bundle_median_t30"] == pytest.approx(float(np.median(t30)), rel=1e-6)
    index = (tmp_path / "bundle" / "reports" / "bundle_report.md").read_text()
    assert "**Taps:** 1 over 2 process(es) / 2 device(s)" in index
    assert (tmp_path / "bundle" / "reports" / names[0] / f"{names[0]}_report.md").is_file()
