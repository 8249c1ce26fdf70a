"""The port's report suite (audio_analysis_tpu_torch/report/report.py) on
the CPU against the JAX package's on the golden IR
(tests/golden_utils.make_golden_ir, stereo, 2^16 samples), both sides built
from one JAX ReportSettings (the port's through settings_from_jax).

- The markdown agrees with the JAX report's and with
  tests/golden/verb_report_golden.md under golden_utils.compare_reports,
  and line by line in structure.
- The same PNG file names, each PNG the same pixel size; the three IR-view
  PNGs byte-identical (the same decoded samples drawn by the same code).
- Every render job (recorded, not run) has the JAX job's function and
  argument structure, its arrays and numbers within the module tolerances
  of tests/_render_jobs.py; every job holds numpy only.
- One 4096-point and one 8192-point STFT and two EDC calls per report.
- The spectrogram (device-pooled image and full-resolution plane) and the
  3D waterfall templates write PNGs byte-identical to fresh figures, as
  tests/test_figure_templates.py holds for the JAX package.
"""

import os
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("matplotlib")

import torch  # noqa: E402
from PIL import Image  # noqa: E402

import golden_utils  # noqa: E402
from _render_jobs import RecordingPlotWorker, compare_jobs, leaves  # noqa: E402
from audio_analysis_tpu.io import write_wav_pcm16  # noqa: E402
from audio_analysis_tpu.report.report import ReportSettings as JaxReportSettings  # noqa: E402
from audio_analysis_tpu.report.report import run_report_from_wav_file as jax_report  # noqa: E402
from audio_analysis_tpu_torch import plot as P  # noqa: E402
from audio_analysis_tpu_torch.analyses import settings_from_jax  # noqa: E402
from audio_analysis_tpu_torch.analyses import spectrogram as S  # noqa: E402
from audio_analysis_tpu_torch.analyses import waterfall as W  # noqa: E402
from audio_analysis_tpu_torch.ops import edc, stft  # noqa: E402
from audio_analysis_tpu_torch.report.report import run_report_from_wav_file  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX and the port report of the golden IR, once with PNGs and
    once with a recording worker each."""
    root = tmp_path_factory.mktemp("torch_report")
    wav = root / "golden_ir.wav"
    write_wav_pcm16(wav, golden_utils.make_golden_ir(), golden_utils.SR)
    jax_settings = JaxReportSettings()
    settings = settings_from_jax(jax_settings)
    jax_jobs, jobs = RecordingPlotWorker(), RecordingPlotWorker()
    return {
        "theirs": jax_report(wav, root / "jax" / "golden", jax_settings),
        "ours": run_report_from_wav_file(wav, root / "port" / "golden", settings, device="cpu"),
        "theirs_jobs": (jax_report(wav, root / "jax_rec" / "golden", jax_settings, plot_worker=jax_jobs), jax_jobs),
        "ours_jobs": (
            run_report_from_wav_file(wav, root / "port_rec" / "golden", settings, plot_worker=jobs, device="cpu"),
            jobs,
        ),
        "root": root,
    }


def test_markdown_matches_jax_and_golden(runs):
    ours, theirs = runs["ours"].summary_markdown, runs["theirs"].summary_markdown
    golden_utils.compare_reports(theirs, ours)
    golden_utils.compare_reports((golden_utils.GOLDEN_DIR / "verb_report_golden.md").read_text(), ours)
    assert golden_utils.skeleton_and_numbers(ours)[0] == golden_utils.skeleton_and_numbers(theirs)[0]
    assert runs["ours"].summary_markdown_path.read_text() == ours
    assert runs["ours_jobs"][0].summary_markdown == ours.replace("/port/", "/port_rec/")


def test_png_names_and_pixel_sizes_match_jax(runs):
    ours_dir, theirs_dir = runs["root"] / "port", runs["root"] / "jax"
    names = sorted(os.listdir(theirs_dir))
    assert sorted(os.listdir(ours_dir)) == names and len(names) == 16
    for name in names:
        if name.endswith(".png"):
            with Image.open(ours_dir / name) as a, Image.open(theirs_dir / name) as b:
                assert a.size == b.size, name
    # every image the markdown embeds is there
    for line in runs["ours"].summary_markdown.splitlines():
        if line.startswith("!["):
            assert (ours_dir / line[line.rindex("(") + 1 : -1]).is_file(), line


def test_ir_view_pngs_byte_identical_to_jax(runs):
    for name in ("golden.png", "golden_early.png", "golden_tail.png"):
        assert (runs["root"] / "port" / name).read_bytes() == (runs["root"] / "jax" / name).read_bytes(), name


def test_render_jobs_match_jax_within_module_tolerances(runs):
    worst = compare_jobs(runs["theirs_jobs"][1].jobs, runs["ours_jobs"][1].jobs)
    assert len(worst) == 9 and all(v <= 1.0 for v in worst.values())
    for job in runs["ours_jobs"][1].jobs:
        assert not any(isinstance(v, torch.Tensor) for v in leaves(job).values())


def test_each_stft_size_and_edc_runs_once(tmp_path, monkeypatch):
    wav = tmp_path / "golden_ir.wav"
    write_wav_pcm16(wav, golden_utils.make_golden_ir(), golden_utils.SR)
    sizes, edc_rows = [], []
    real_stft, real_edc = stft.stft_mag_db, edc.schroeder_edc_db

    def counted_stft(x, length, n_fft, *args, **kwargs):
        sizes.append(int(n_fft))
        return real_stft(x, length, n_fft, *args, **kwargs)

    def counted_edc(x, length, *args, **kwargs):
        edc_rows.append(x.numel() // x.shape[-1])
        return real_edc(x, length, *args, **kwargs)

    monkeypatch.setattr(stft, "stft_mag_db", counted_stft)
    monkeypatch.setattr(edc, "schroeder_edc_db", counted_edc)
    settings = settings_from_jax(JaxReportSettings(include_timing_footer=True))
    result = run_report_from_wav_file(wav, tmp_path / "out" / "golden", settings, RecordingPlotWorker(), "cpu")
    assert sorted(sizes) == [4096, 8192]
    assert edc_rows == [2, 6]  # decay: 2 channels; rt60bands: 3 bands x 2 channels
    assert "## Timing" in result.summary_markdown and "| **total** |" in result.summary_markdown


@pytest.fixture
def fresh_templates():
    old = P.FIGURE_TEMPLATES_ENABLED
    P.clear_figure_templates()
    P.clear_tight_bbox_cache()
    yield
    P.FIGURE_TEMPLATES_ENABLED = old
    P.clear_figure_templates()
    P.clear_tight_bbox_cache()


def _spectrogram_results(seed: int, frames: int, display: bool):
    rng = np.random.default_rng(seed)
    n_fft, hop, sr = 4096, 512, 48_000
    n_bins = n_fft // 2 + 1
    out = []
    for name in ("left", "right"):
        mag = rng.uniform(-120.0, 0.0, (n_bins, frames)).astype(np.float32)
        shown = None
        if display:
            image = rng.uniform(-120.0, 0.0, (720, frames)).astype(np.float32)
            shown = S.SpectrogramDisplayData(image, float(np.percentile(image, 99.5)), -100.0, n_fft, frames)
            mag = np.zeros((0, 0), np.float32)
        out.append(
            S.ChannelSpectrogramResult(
                name, sr, 0, frames * hop, (np.arange(frames) * hop / sr).astype(np.float32),
                np.linspace(0.0, sr / 2, n_bins).astype(np.float32), mag, shown,
            )
        )
    return out


@pytest.mark.parametrize("display", [True, False], ids=["device_pooled_image", "full_resolution_plane"])
def test_spectrogram_template_byte_identical(tmp_path, fresh_templates, display):
    cases = [(0, 180, "tapA.wav"), (1, 150, "tapB.wav"), (0, 180, "tapA.wav")]

    def render(tag, seed, frames, source):
        results = _spectrogram_results(seed, frames, display)
        S.render_spectrogram_plots(
            results, S.SpectrogramAnalysisSettings(), S.SpectrogramPlotSettings(), tmp_path / tag, False, source
        )
        return [(tmp_path / f"{tag}_spectrogram_{r.channel_name}.png").read_bytes() for r in results]

    P.FIGURE_TEMPLATES_ENABLED = False
    refs = [render(f"fresh{i}", *case) for i, case in enumerate(cases)]
    P.FIGURE_TEMPLATES_ENABLED = True
    gots = [render(f"tpl{i}", *case) for i, case in enumerate(cases)]
    assert len(P._FIGURE_TEMPLATES) == 1
    assert gots == refs


def test_waterfall_3d_template_byte_identical(tmp_path, fresh_templates):
    def results(seed, n_slices):
        rng = np.random.default_rng(seed)
        f = np.linspace(0.0, 24_000.0, 2049).astype(np.float32)
        times = (np.arange(n_slices) * 0.05).astype(np.float32)
        mags = rng.uniform(-90.0, 0.0, (n_slices, 2049)).astype(np.float32)
        return [W.ChannelWaterfallResult("left", 48_000, 0, 96_000, times, f, mags)]

    def render(tag, seed, n_slices):
        W.render_waterfall_plots(
            results(seed, n_slices), W.WaterfallAnalysisSettings(), W.WaterfallPlotSettings(), tmp_path / tag,
            False, f"t{seed}.wav",
        )
        return (tmp_path / f"{tag}_waterfall_left.png").read_bytes()

    P.FIGURE_TEMPLATES_ENABLED = False
    refs = [render(f"fresh{i}", i, 18 - i) for i in range(3)]
    P.FIGURE_TEMPLATES_ENABLED = True
    gots = [render(f"tpl{i}", i, 18 - i) for i in range(3)]
    assert len(P._FIGURE_TEMPLATES) == 1
    assert gots == refs


def test_report_of_a_mono_file_names_one_channel(tmp_path):
    wav = tmp_path / "mono.wav"
    write_wav_pcm16(wav, golden_utils.make_golden_ir()[:, :1], golden_utils.SR)
    jobs = RecordingPlotWorker()
    md = run_report_from_wav_file(wav, tmp_path / "m", settings_from_jax(JaxReportSettings()), jobs, "cpu")
    text = md.summary_markdown
    assert "m_spectrogram_mono.png" in text and "m_groupdelay_mono.png" in text and "right" not in text
    assert Path(f"{tmp_path / 'm'}_report.md").is_file()
