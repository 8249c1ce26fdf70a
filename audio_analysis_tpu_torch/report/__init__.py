"""The engine bundle report (per-tap markdown + bundle_metrics.json), the
run-to-run comparison of two reports, and the bundle watcher. The plot
reports live in report.report (ReportSettings, run_report_from_wav_file),
report.bundle (BundleRunSettings, run_bundle_report) and report.warmup;
they import the analyses, which import report.waterfall, so they are not
re-exported here."""

from audio_analysis_tpu_torch.report.compare import (  # noqa: F401
    count_flagged_in_text,
    format_bundle_comparison,
    index_has_flagged_changes,
    load_bundle_metrics,
)
from audio_analysis_tpu_torch.report.engine_report import (  # noqa: F401
    EngineBundleSettings,
    run_bundle_report_engine,
)
from audio_analysis_tpu_torch.report.watch import (  # noqa: F401
    WatchSettings,
    watch_bundle_runs,
)
