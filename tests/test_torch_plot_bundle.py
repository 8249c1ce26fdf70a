"""The port's plot bundle runner (audio_analysis_tpu_torch/report/bundle.py)
and its plot workers (parallel/overlap.py, parallel/procpool.py) on the
CPU, over a 3-tap bundle of 2^15-sample stereo taps, against the JAX
package's run_bundle_report.

- The index text equals the JAX one with the paths aside; every tap's
  markdown agrees with the JAX tap's (golden_utils.compare_reports), and
  the PNGs written are exactly those the JAX markdown embeds.
- `resume`: every tap "(cached)" and no report is run; a tap missing a
  PNG is rendered again. `tap_shard` "0/2": the shard summary lists taps 0
  and 2, and a resume run then writes the full index from cache.
- plot_timings.json: one entry per render function (and the template
  warmup), each with seconds, jobs, first_job_seconds and cpu_seconds.
- The spawn-based process pool writes the same markdown and PNG set as
  the thread worker; its children see CUDA_VISIBLE_DEVICES="" and
  MPLBACKEND=Agg, and the parent's environment is left as it was.
- A failing render job is reported by drain_collect (thread worker and
  process pool) and listed in the index; the other jobs still run.
- Every render job of a report pickles and holds no torch.Tensor.
"""

import functools
import json
import operator
import os
import pickle
import re
import shutil
from pathlib import Path
from unittest import mock

import pytest

pytest.importorskip("jax")
pytest.importorskip("matplotlib")

import torch  # noqa: E402

import golden_utils  # noqa: E402
from _render_jobs import RecordingPlotWorker, job_name, leaves, write_environment  # noqa: E402
from audio_analysis_tpu.report.bundle import BundleRunSettings as JaxBundleRunSettings  # noqa: E402
from audio_analysis_tpu.report.bundle import run_bundle_report as jax_run_bundle_report  # noqa: E402
from audio_analysis_tpu.report.report import ReportSettings as JaxReportSettings  # noqa: E402
from audio_analysis_tpu_torch.analyses import settings_from_jax  # noqa: E402
from audio_analysis_tpu_torch.parallel import procpool  # noqa: E402
from audio_analysis_tpu_torch.parallel.overlap import MaybePlotWorker  # noqa: E402
from audio_analysis_tpu_torch.report import bundle, warmup  # noqa: E402
from audio_analysis_tpu_torch.report.report import run_report_from_wav_file  # noqa: E402
from test_torch_bundle import _write_bench_bundle  # noqa: E402

torch.set_num_threads(2)
TAPS = 3
N = 1 << 15
RENDER_KINDS = {
    "plot_ir_from_wav_file", "render_decay_plots", "render_rt60_bands_plots", "render_frequency_response_plots",
    "render_group_delay_plots", "render_spectrogram_plots", "render_waterfall_plots", "render_diffusion_plots",
    "render_modal_cloud_plots",
}


def _settings(subdir: str, **kwargs):
    jax_settings = JaxBundleRunSettings(reports_subdir=subdir, **kwargs)
    return jax_settings, settings_from_jax(jax_settings)


def _files(reports: Path) -> dict:
    return {
        str(p.relative_to(reports)): p.stat().st_size
        for p in sorted(reports.rglob("*"))
        if p.is_file() and p.suffix in (".md", ".png")
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = _write_bench_bundle(tmp_path_factory.mktemp("plot_bundle"), TAPS, N)
    jax_settings, settings = _settings("reports_jax")
    # the JAX side's figures are recorded, not drawn: its markdown names
    # every PNG a tap has
    with mock.patch("audio_analysis_tpu.report.bundle.make_plot_worker", return_value=RecordingPlotWorker()):
        jax_index = jax_run_bundle_report(root, jax_settings)
    index = bundle.run_bundle_report(root, _settings("reports")[1], device="cpu")
    return {"root": root, "jax_index": jax_index, "index": index, "settings": settings}


def test_index_and_tap_reports_match_jax(runs):
    root = runs["root"]
    ours = runs["index"].read_text().replace(str(root), "ROOT")
    theirs = runs["jax_index"].read_text().replace(str(root), "ROOT")
    assert ours == theirs
    assert all(f"- [tap{i:02d}](tap{i:02d}/tap{i:02d}_report.md)" in ours for i in range(TAPS))
    for i in range(TAPS):
        tap = f"tap{i:02d}"
        golden_utils.compare_reports(
            (root / "reports_jax" / tap / f"{tap}_report.md").read_text(),
            (root / "reports" / tap / f"{tap}_report.md").read_text(),
        )
    names = {k for k in _files(root / "reports") if k.endswith(".png")}
    embedded = {
        f"{tap}/{m}"
        for tap in (f"tap{i:02d}" for i in range(TAPS))
        for m in re.findall(r"!\[[^\]]*\]\(([^)]+)\)", (root / "reports_jax" / tap / f"{tap}_report.md").read_text())
    }
    assert names == embedded and len(names) == TAPS * 15


def test_plot_timings_json_keys(runs):
    timings = json.loads((runs["root"] / "reports" / "plot_timings.json").read_text())
    assert set(timings) == RENDER_KINDS | {"warmup_figure_templates"}
    for kind, entry in timings.items():
        assert set(entry) == {"seconds", "jobs", "first_job_seconds", "cpu_seconds"}, kind
        assert entry["jobs"] == (1 if kind == "warmup_figure_templates" else TAPS)
    # the warmup ran on the render thread on the CPU and completed
    assert warmup._WARMUP_DONE


def test_resume_caches_every_complete_tap(runs):
    root = runs["root"]
    shutil.copytree(root / "reports", root / "reports_resume")
    with mock.patch.object(bundle, "run_report_from_wav_file") as report:
        index = bundle.run_bundle_report(root, _settings("reports_resume", resume=True)[1], device="cpu")
    assert report.call_count == 0
    text = index.read_text()
    assert all(f"- [tap{i:02d}](tap{i:02d}/tap{i:02d}_report.md) (cached)" in text for i in range(TAPS))
    assert json.loads((root / "reports_resume" / "plot_timings.json").read_text()) == {}
    # a tap missing one embedded PNG is not complete
    (root / "reports_resume" / "tap01" / "tap01_decay.png").unlink()
    with mock.patch.object(bundle, "run_report_from_wav_file") as report:
        bundle.run_bundle_report(root, _settings("reports_resume", resume=True)[1], device="cpu")
    assert [c.kwargs["input_wav_file_path"].name for c in report.call_args_list] == ["tap01.wav"]


def test_tap_shard_then_resume_merges_the_index(runs, tmp_path):
    root = runs["root"]
    shard = bundle.run_bundle_report(root, _settings("reports_shard", tap_shard="1/2")[1], device="cpu")
    assert shard.name == "bundle_shard_1of2.md"
    text = shard.read_text()
    assert text == "# IR Bundle Report — shard 1/2\n\n- [tap01](tap01/tap01_report.md)\n"
    assert (root / "reports_shard" / "plot_timings_shard1of2.json").is_file()
    with mock.patch.object(bundle, "run_report_from_wav_file") as report:
        index = bundle.run_bundle_report(root, _settings("reports_shard", resume=True)[1], device="cpu")
    assert [c.kwargs["input_wav_file_path"].name for c in report.call_args_list] == ["tap00.wav", "tap02.wav"]
    assert "- [tap01](tap01/tap01_report.md) (cached)" in index.read_text()
    with pytest.raises(ValueError, match="i/n"):
        bundle.run_bundle_report(root, _settings("reports_bad", tap_shard="2")[1], device="cpu")


def test_process_pool_writes_the_thread_workers_files(runs, tmp_path):
    root = runs["root"]
    settings = settings_from_jax(
        JaxBundleRunSettings(
            reports_subdir="reports_procs",
            report_settings=JaxReportSettings(plot_processes=2, warmup_figure_templates=False),
        )
    )
    bundle.run_bundle_report(root, settings, device="cpu")
    ours, ref = _files(root / "reports_procs"), _files(root / "reports")
    assert sorted(ours) == sorted(ref)
    for name in ours:
        if name.endswith(".md") and name != "bundle_report.md":
            assert (root / "reports_procs" / name).read_text() == (root / "reports" / name).read_text()
        elif name.endswith(".png"):
            assert ours[name] > 1000, name
    timings = json.loads((root / "reports_procs" / "plot_timings.json").read_text())
    assert set(timings) == RENDER_KINDS and timings["render_decay_plots"]["jobs"] == TAPS


@pytest.mark.parametrize("processes", [0, 2], ids=["thread", "process_pool"])
def test_failing_render_job_is_reported_by_drain_collect(tmp_path, processes):
    worker = procpool.ProcessPlotPool(processes) if processes else MaybePlotWorker(True)
    out = tmp_path / "ok.txt"
    try:
        worker.submit(functools.partial(operator.truediv, 1, 0), "bad tap")
        worker.submit(functools.partial(Path.write_text, out, "ok"), "good tap")
        failures = worker.drain_collect()
        assert [(label, type(exc).__name__) for label, exc in failures] == [("bad tap", "ZeroDivisionError")]
        assert out.read_text() == "ok" and worker.drain_collect() == []
        assert worker.timings_by_kind()["truediv"][1] == 1
        if processes:
            # the children see no card; the parent's environment is restored
            before = dict(os.environ)
            env = tmp_path / "env.json"
            worker.submit(functools.partial(write_environment, env, tuple(procpool._CHILD_ENV)))
            assert worker.drain_collect() == [] and dict(os.environ) == before
            assert json.loads(env.read_text()) == {"CUDA_VISIBLE_DEVICES": "", "MPLBACKEND": "Agg"}
    finally:
        worker.close()


def test_failed_render_is_listed_in_the_index(runs, tmp_path):
    root = runs["root"]
    with mock.patch("audio_analysis_tpu_torch.report.report.render_decay_plots", side_effect=OSError("disk full")):
        index = bundle.run_bundle_report(root, _settings("reports_fail", tap_shard="0/3")[1], device="cpu")
    text = index.read_text()
    assert "## Failures" in text and "plot rendering (" in text and "OSError: disk full" in text
    assert not bundle._report_complete(root / "reports_fail" / "tap00" / "tap00_report.md")


def test_render_jobs_pickle_and_hold_no_tensor(runs, tmp_path):
    jobs = RecordingPlotWorker()
    run_report_from_wav_file(
        runs["root"] / "taps" / "tap00.wav", tmp_path / "t", runs["settings"].report_settings, jobs, "cpu"
    )
    assert {job_name(j) for j in jobs.jobs} == RENDER_KINDS
    for job in jobs.jobs:
        assert not any(isinstance(v, torch.Tensor) for v in leaves(job).values())
        again = pickle.loads(pickle.dumps(job))
        assert again.func is job.func
