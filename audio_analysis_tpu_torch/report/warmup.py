"""
Figure-template warmup (audio_analysis_tpu/report/warmup.py): build every
plot kind's live template, and matplotlib's first-draw caches (font
manager, Agg raster state, tight-bbox layout), before the first real tap
renders.

The bundle runner submits this as the first plot-worker job, so the
template builds run on the render thread (or in each render process)
while the first tap's device work is in flight. It renders a full report
over a tiny synthetic stereo IR (24,576 samples at the real sample rate)
with the bundle's own ReportSettings into a throwaway directory, so the
warm templates' keys are the real taps' keys. The analyses run with
`device="cpu"` (the plain torch versions): the warmup never contends for
the card and never counts in the kernels' launch counters.

Best effort: any failure is swallowed, and the real renders then build
their templates themselves.
"""

from __future__ import annotations

import shutil
import tempfile
from dataclasses import replace
from pathlib import Path

# set once a warmup report has completed in this process: later bundles
# (a watch service) reuse its templates. Not inferred from the template
# cache being non-empty: a single-file report leaves only its own kinds.
_WARMUP_DONE = False


def warmup_figure_templates(report_settings) -> None:
    """Render one tiny throwaway report inline on the calling (render)
    thread, filling the figure-template cache for every enabled kind."""
    global _WARMUP_DONE
    try:
        if _WARMUP_DONE:
            return

        import numpy as np

        from audio_analysis_tpu_torch.io.wav import write_wav_pcm16
        from audio_analysis_tpu_torch.report.report import ReportSettings, run_report_from_wav_file

        if report_settings is None:
            report_settings = ReportSettings()
        sr = int(report_settings.expected_sample_rate_hz)
        # 24,576 samples, rt60 250 ms: enough frames for the waterfall's
        # default slice count, at least 10 modal fit frames in the -5..-35
        # dB window (a scatter, not the empty panel) and every decay fit
        # range found, so each warm figure has a real tap's artists
        n = 24_576
        t = np.arange(n) / sr
        rng = np.random.default_rng(0)
        x = np.zeros((n, 2), np.float32)
        env = 10.0 ** (-3.0 * t / 0.25)
        x[64:, :] = (0.05 * rng.standard_normal((n - 64, 2)) * env[: n - 64, None]).astype(np.float32)
        x[64, :] = 0.9

        inline = replace(
            report_settings,
            overlap_plotting=False,  # render on this thread: the template
            plot_processes=0,  # cache is per render thread / process
            include_timing_footer=False,
            warmup_figure_templates=False,
        )
        tmp = Path(tempfile.mkdtemp(prefix="aa_torch_template_warmup_"))
        try:
            wav = tmp / "warmup.wav"
            write_wav_pcm16(wav, x, sr)
            run_report_from_wav_file(wav, tmp / "out" / "warmup", settings=inline, device="cpu")
            _WARMUP_DONE = True
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    except Exception:  # noqa: BLE001 — warmup is strictly best-effort
        pass
