"""The engine bundle report (per-tap markdown + bundle_metrics.json)."""

from audio_analysis_tpu_torch.report.engine_report import (  # noqa: F401
    EngineBundleSettings,
    run_bundle_report_engine,
)
