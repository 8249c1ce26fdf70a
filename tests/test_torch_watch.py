"""The port's bundle watcher (audio_analysis_tpu_torch/report/watch.py) on
the CPU: new bundles and their comparison with the one analysed before,
re-recording in place, incomplete bundles, a corrupt state file, the
retry budget, the device audio cache across cycles, the plot reports
(drawn once, then only for the re-recorded taps), the `watch` subcommand,
and the JAX package's watcher on the same bundles.

Every watch here is bounded: `max_bundles`, `poll_seconds=0.05`,
`settle_seconds=0` and a `stop()` deadline, so a fault ends the test
instead of hanging the run.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_analysis_tpu_torch.io import native, write_bundle
from audio_analysis_tpu_torch.report import EngineBundleSettings, WatchSettings, watch_bundle_runs

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SR = 48_000
N = 1 << 13


def _taps(count: int, scale_first: float = 1.0) -> dict:
    rng = np.random.default_rng(5)
    t = np.arange(N) / SR
    taps = {}
    for i in range(count):
        x = np.zeros((N, 2), np.float32)
        x[32:] = 0.05 * rng.standard_normal((N - 32, 2)) * 10.0 ** (-3.0 * t[: N - 32, None] / (0.1 + 0.02 * i))
        x[32] = 0.9
        taps[f"tap{i}"] = x * (scale_first if i == 0 else 1.0)
    return taps


def _watch(root, max_bundles=None, seconds=60.0, logs=None, **kwargs):
    """watch_bundle_runs on the CPU, bounded by max_bundles and a deadline."""
    deadline = time.monotonic() + seconds
    settings = WatchSettings(poll_seconds=0.05, settle_seconds=0.0, max_bundles=max_bundles, **kwargs)
    log = (logs.append if logs is not None else lambda _msg: None)
    return watch_bundle_runs(root, settings, log=log, stop=lambda: time.monotonic() > deadline, device="cpu")


def _log_lines(root: Path) -> list:
    return [json.loads(line) for line in (root / "watch_log.jsonl").read_text().splitlines()]


def test_new_bundles_are_analysed_and_compared(tmp_path):
    write_bundle(tmp_path / "run1", _taps(2), SR)
    write_bundle(tmp_path / "run2", _taps(2, scale_first=0.9), SR)
    written = _watch(tmp_path, max_bundles=2)
    assert written == [tmp_path / "run1" / "reports" / "bundle_report.md",
                       tmp_path / "run2" / "reports" / "bundle_report.md"]
    assert "## Changes vs" not in written[0].read_text()
    second = written[1].read_text()
    assert "## Changes vs `" + str(tmp_path / "run1" / "reports" / "bundle_metrics.json") in second
    assert "- tap0 [" in second and "- tap1 [" not in second
    events = _log_lines(tmp_path)
    assert [e["bundle"] for e in events] == ["run1", "run2"]
    assert events[0]["flagged_changes"] == 0 and events[1]["flagged_changes"] >= 1
    state = json.loads((tmp_path / ".aa_watch_state.json").read_text())
    assert sorted(state["analyzed"]) == [str(tmp_path / "run1"), str(tmp_path / "run2")]
    assert state["last_metrics"] == str(tmp_path / "run2" / "reports" / "bundle_metrics.json")
    # a restart finds nothing new
    assert _watch(tmp_path, seconds=0.5) == []


def test_rerecording_in_place_is_analysed_again(tmp_path):
    root = write_bundle(tmp_path / "bundle", _taps(2), SR)
    assert len(_watch(root, max_bundles=1)) == 1
    write_bundle(root, _taps(2, scale_first=0.5), SR)
    logs = []
    (index,) = _watch(root, max_bundles=1, logs=logs)
    assert "## Changes vs" in index.read_text()
    assert any(msg.startswith("analysed bundle: 2 taps") and "changes vs previous" in msg for msg in logs)
    assert len(_log_lines(root)) == 2


def test_incomplete_bundles_are_skipped(tmp_path):
    write_bundle(tmp_path / "partial", _taps(1), SR)
    meta = json.loads((tmp_path / "partial" / "meta.json").read_text())
    meta["taps"].append("not_yet_written")
    (tmp_path / "partial" / "meta.json").write_text(json.dumps(meta))
    (tmp_path / "garbled").mkdir()
    (tmp_path / "garbled" / "meta.json").write_text("{not json")
    assert _watch(tmp_path, seconds=0.5) == []
    assert not (tmp_path / "partial" / "reports").exists()


def test_corrupt_state_file_starts_fresh(tmp_path):
    write_bundle(tmp_path / "run1", _taps(1), SR)
    (tmp_path / ".aa_watch_state.json").write_text("{truncated")
    assert len(_watch(tmp_path, max_bundles=1)) == 1
    assert json.loads((tmp_path / ".aa_watch_state.json").read_text())["analyzed"]


def test_state_keys_of_the_jax_watcher_survive_a_cycle(tmp_path):
    """The figure-skip cache of the state file (plot_sigs,
    plot_sigs_settings), which the port's watcher now keeps as the JAX
    watcher does, survives a cycle without plots when it was written for
    the same figure settings; written for other settings, it is dropped
    and the current settings recorded, as the JAX watcher does."""
    write_bundle(tmp_path / "run1", _taps(1), SR)
    plot_sigs = {str(tmp_path / "old"): {"tap0": "sig"}}
    current = repr(("mono", False))  # the JAX watcher's fingerprint of the default settings
    (tmp_path / ".aa_watch_state.json").write_text(json.dumps(
        {"analyzed": {}, "last_metrics": None, "plot_sigs": plot_sigs, "plot_sigs_settings": current}
    ))
    assert len(_watch(tmp_path, max_bundles=1)) == 1
    state = json.loads((tmp_path / ".aa_watch_state.json").read_text())
    assert state["plot_sigs"] == plot_sigs and state["plot_sigs_settings"] == current
    write_bundle(tmp_path / "run2", _taps(1), SR)
    state["plot_sigs_settings"] = "abc"
    (tmp_path / ".aa_watch_state.json").write_text(json.dumps(state))
    assert len(_watch(tmp_path, max_bundles=1)) == 1
    state = json.loads((tmp_path / ".aa_watch_state.json").read_text())
    assert state["plot_sigs"] == {} and state["plot_sigs_settings"] == current
    assert list(state["analyzed"]) == [str(tmp_path / "run1"), str(tmp_path / "run2")]


def test_failing_bundle_is_retried_then_given_up(tmp_path):
    write_bundle(tmp_path / "broken", _taps(1), SR)
    (tmp_path / "broken" / "taps" / "tap0.wav").write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunk")
    logs = []
    assert _watch(tmp_path, seconds=1.5, logs=logs, max_failures_per_bundle=2) == []
    failed = [msg for msg in logs if msg.startswith("FAILED broken")]
    assert len(failed) == 2
    assert "attempt 1/2, will retry" in failed[0] and "attempt 2/2, giving up" in failed[1]
    state = json.loads((tmp_path / ".aa_watch_state.json").read_text())
    assert state["failures"][str(tmp_path / "broken")]["count"] == 2


def test_unchanged_chunks_stay_on_the_device_across_cycles(tmp_path):
    """One tap per chunk; re-recording one of three taps re-uploads one
    chunk and serves two from the device audio cache."""
    assert native.ensure_built()  # the pipelined PCM16 path holds the cache
    root = write_bundle(tmp_path / "bundle", _taps(3), SR)
    engine = EngineBundleSettings(chunk_taps=1)
    assert len(_watch(root, max_bundles=1, engine=engine)) == 1
    write_bundle(root, {"tap0": _taps(1, scale_first=0.5)["tap0"]}, SR)
    meta = json.loads((root / "meta.json").read_text())
    meta["taps"] = ["tap0", "tap1", "tap2"]
    (root / "meta.json").write_text(json.dumps(meta))
    assert len(_watch(root, max_bundles=1, engine=engine)) == 1
    first, second = _log_lines(root)
    assert (first["audio_chunks_reused"], first["audio_chunks_uploaded"]) == (0, 3)
    assert (second["audio_chunks_reused"], second["audio_chunks_uploaded"]) == (2, 1)


def test_plot_reports_are_refused(tmp_path):
    """The plot reports of the watcher were refused; they are ported now
    (the test keeps its name). Every tap is drawn into reports_plots the
    first time; after one tap is re-recorded in place, only that tap is
    drawn again, and the event log counts both."""
    pytest.importorskip("matplotlib")
    root = tmp_path / "bundle"
    long_taps = {name: np.tile(x, (4, 1)) for name, x in _taps(2).items()}  # 2^15 samples: every analysis runs
    write_bundle(root, long_taps, SR)
    assert len(_watch(root, max_bundles=1, plots=True)) == 1
    plots = root / "reports_plots"
    first = {q.name: q.stat().st_mtime_ns for q in (plots / "tap1").glob("*.png")}
    assert len(first) == 15 and len(list((plots / "tap0").glob("*.png"))) == 15
    time.sleep(0.05)
    write_bundle(root, {"tap0": long_taps["tap0"] * 0.5}, SR)
    meta = json.loads((root / "meta.json").read_text())
    meta["taps"] = ["tap0", "tap1"]
    (root / "meta.json").write_text(json.dumps(meta))
    assert len(_watch(root, max_bundles=1, plots=True)) == 1
    assert {q.name: q.stat().st_mtime_ns for q in (plots / "tap1").glob("*.png")} == first
    events = _log_lines(root)
    assert [(e["figures_rendered_taps"], e["figures_skipped_taps"]) for e in events] == [(2, 0), (1, 1)]
    state = json.loads((root / ".aa_watch_state.json").read_text())
    assert set(state["plot_sigs"][str(root)]) == {"tap0", "tap1"}


def test_watch_subcommand(tmp_path):
    write_bundle(tmp_path / "run1", _taps(1), SR)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "audio_analysis_tpu_torch.cli", "watch", "--input", str(tmp_path),
         "--max-bundles", "1", "--interval", "0.05", "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "analysed run1: 1 taps" in proc.stdout
    assert (tmp_path / "run1" / "reports" / "bundle_metrics.json").is_file()


def test_watch_agrees_with_the_jax_watcher(tmp_path):
    """The same two bundles (one tap re-recorded at 0.9x) watched by the JAX
    package's watcher and by the port's: the same indexes, the same flagged
    cells in the second one (compared by label: the printed values come
    from two engines and may differ in the last digit), and event logs with
    the same fields and counts."""
    pytest.importorskip("jax")
    from audio_analysis_tpu.io import native as jax_native
    from audio_analysis_tpu.report import EngineBundleSettings as JaxEngineBundleSettings
    from audio_analysis_tpu.report import WatchSettings as JaxWatchSettings
    from audio_analysis_tpu.report import watch_bundle_runs as jax_watch_bundle_runs

    assert native.ensure_built() == jax_native.ensure_built()  # one loader branch on both sides
    for side in ("ours", "theirs"):
        write_bundle(tmp_path / side / "run1", _taps(2), SR)
        write_bundle(tmp_path / side / "run2", _taps(2, scale_first=0.9), SR)
    ours = _watch(tmp_path / "ours", max_bundles=2)
    deadline = time.monotonic() + 120.0
    theirs = jax_watch_bundle_runs(
        tmp_path / "theirs",
        JaxWatchSettings(poll_seconds=0.05, settle_seconds=0.0, max_bundles=2,
                         engine=JaxEngineBundleSettings(use_device_mesh="off")),
        log=lambda _msg: None, stop=lambda: time.monotonic() > deadline,
    )
    assert [p.relative_to(tmp_path / "ours") for p in ours] == [p.relative_to(tmp_path / "theirs") for p in theirs]

    def flagged_cells(index: Path) -> list:
        return [line.split(":")[0] for line in index.read_text().splitlines() if line.startswith("- ")]

    assert flagged_cells(ours[1]) == flagged_cells(theirs[1]) and flagged_cells(ours[1])
    ours_log, theirs_log = _log_lines(tmp_path / "ours"), _log_lines(tmp_path / "theirs")
    assert [sorted(e) for e in ours_log] == [sorted(e) for e in theirs_log]
    for a, b in zip(ours_log, theirs_log):
        for key in ("bundle", "taps", "flagged_changes", "audio_chunks_reused", "audio_chunks_uploaded"):
            assert a.get(key) == b.get(key), key
