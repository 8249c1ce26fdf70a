"""
The plot bundle runner (audio_analysis_tpu/report/bundle.py): one full
report per tap of a capture bundle (meta.json + taps/*.wav) into
<bundle_root>/<reports_subdir>/<tap>/, and the bundle_report.md index
with links relative to it.

- Per-tap failure isolation: a failing tap is listed in the index (its
  traceback in <tap>/error.txt) and the run goes on, unless
  continue_on_error is off.
- `resume`: a tap whose markdown and every PNG it embeds exist is
  "(cached)" and not analysed again.
- `tap_shard="i/n"`: only the taps with index % n == i, for fanning the
  rendering over processes or machines on a shared filesystem; a shard
  writes a shard summary instead of the index, and one `resume` run
  without a shard writes the index from the completed taps.
- `render_only_taps`: only these taps are rendered again; every other
  complete tap is cached.
- One plot worker for the whole bundle: tap k's figures render while tap
  k+1's analyses run on the device. Its per-kind render seconds go to
  plot_timings.json (one per shard), written on every exit.
"""

from __future__ import annotations

import json
import re
import traceback
from dataclasses import dataclass
from functools import partial
from pathlib import Path
from typing import List, Optional

import torch

from audio_analysis_tpu_torch.parallel.overlap import make_plot_worker
from audio_analysis_tpu_torch.report.report import ReportSettings, run_report_from_wav_file


@dataclass(frozen=True)
class BundleRunSettings:
    reports_subdir: str = "reports"
    report_settings: Optional[ReportSettings] = None
    resume: bool = False  # skip taps with a complete report
    continue_on_error: bool = True
    # "i/n" (0-based): render only the taps with index % n == i
    tap_shard: Optional[str] = None
    # when set, only these taps are rendered again; every other tap is
    # cached if its report is complete (and rendered if not)
    render_only_taps: Optional[tuple] = None


def _parse_tap_shard(spec: str) -> tuple:
    try:
        index_text, count_text = spec.split("/", 1)
        shard_index, shard_count = int(index_text), int(count_text)
    except ValueError:
        raise ValueError(f"tap_shard must look like 'i/n' (0-based), got {spec!r}") from None
    if shard_count < 1 or not (0 <= shard_index < shard_count):
        raise ValueError(f"tap_shard {spec!r} needs 0 <= i < n")
    return shard_index, shard_count


_MD_IMAGE_RE = re.compile(r"!\[[^\]]*\]\(([^)]+)\)")


def _report_complete(report_md: Path) -> bool:
    """A tap is done for `resume` only if its markdown exists and every PNG
    it embeds exists beside it: the markdown is written before the tap's
    figure jobs drain, so an interrupted or plot-failed run can leave a
    markdown without its images."""
    if not report_md.exists():
        return False
    try:
        text = report_md.read_text()
    except OSError:
        return False
    return all((report_md.parent / name).exists() for name in _MD_IMAGE_RE.findall(text))


def run_bundle_report(
    bundle_root: str | Path,
    settings: Optional[BundleRunSettings] = None,
    device: "str | torch.device" = "cuda",
) -> Path:
    """Every tap's report on `device`; returns the index (or, for a shard,
    the shard summary)."""
    if settings is None:
        settings = BundleRunSettings()
    bundle_root = Path(bundle_root)
    meta_path = bundle_root / "meta.json"
    if not meta_path.exists():
        raise ValueError(
            f"Not a capture bundle: {bundle_root} has no meta.json "
            "(expected the recorder layout: meta.json + taps/*.wav)"
        )
    meta = json.loads(meta_path.read_text())
    tap_names: List[str] = list(meta.get("taps", []))
    taps_dir = bundle_root / "taps"

    shard = _parse_tap_shard(settings.tap_shard) if settings.tap_shard else None
    if shard is not None:
        tap_names = [t for j, t in enumerate(tap_names) if j % shard[1] == shard[0]]

    reports_root = bundle_root / settings.reports_subdir
    reports_root.mkdir(parents=True, exist_ok=True)
    header_lines: List[str] = [
        "# IR Bundle Report\n",
        f"**Bundle:** `{bundle_root}`\n",
        f"**Sample rate:** {meta.get('sample_rate_hz')}\n",
        f"**Length (samples):** {meta.get('length_samples')}\n",
        "\n## Taps\n",
    ]
    # the per-tap entries and the failures: what a shard summary shares
    # with the index
    tap_lines: List[str] = []
    failures: List[str] = []

    report_settings = settings.report_settings or ReportSettings()
    plot_worker = make_plot_worker(report_settings.overlap_plotting, report_settings.plot_processes)
    # the template warmup rides the worker as its first job(s), one per
    # pool process, submitted with the first tap that is rendered (a fully
    # cached resume pays nothing); a synchronous worker has nothing to
    # overlap it with, so it is off there
    warmup_pending = bool(report_settings.warmup_figure_templates) and (
        report_settings.overlap_plotting or int(report_settings.plot_processes) > 0
    )

    try:
        for tap in tap_names:
            wav_path = taps_dir / f"{tap}.wav"
            out_dir = reports_root / tap
            out_dir.mkdir(parents=True, exist_ok=True)
            report_md = out_dir / f"{tap}_report.md"
            unchanged = settings.render_only_taps is not None and tap not in settings.render_only_taps
            if (settings.resume or unchanged) and _report_complete(report_md):
                tap_lines.append(f"- [{tap}]({tap}/{report_md.name}) (cached)")
                continue

            if warmup_pending:
                from audio_analysis_tpu_torch.report.warmup import warmup_figure_templates

                warmup_pending = False
                for _ in range(max(1, int(report_settings.plot_processes))):
                    plot_worker.submit(partial(warmup_figure_templates, report_settings), "template_warmup")

            try:
                run_report_from_wav_file(
                    input_wav_file_path=wav_path,
                    output_basename=out_dir / tap,
                    settings=settings.report_settings,
                    plot_worker=plot_worker,
                    device=device,
                )
                # links relative to the index, which lives in reports_subdir
                tap_lines.append(f"- [{tap}]({tap}/{report_md.name})")
            except Exception as exc:  # noqa: BLE001 — per-tap isolation by design
                if not settings.continue_on_error:
                    raise
                failures.append(tap)
                tap_lines.append(f"- {tap}: FAILED ({type(exc).__name__}: {exc})")
                (out_dir / "error.txt").write_text(traceback.format_exc())
    finally:
        # drained even when a tap raised, so no figure job keeps writing
        # PNGs after this function has returned
        plot_failures = plot_worker.drain_collect()
        plot_timings = plot_worker.timings_by_kind()
        plot_worker.close()
        # written on every exit (an empty {} for a fully cached run), one
        # file per shard
        timings_name = "plot_timings.json" if shard is None else f"plot_timings_shard{shard[0]}of{shard[1]}.json"
        (reports_root / timings_name).write_text(
            json.dumps(
                {
                    kind: {
                        "seconds": round(seconds, 4),
                        "jobs": jobs,
                        # the first job of a kind pays the template build
                        "first_job_seconds": round(first, 4),
                        # CPU seconds on the render thread / process: the
                        # stable attribution (wall inflates with contention)
                        "cpu_seconds": round(cpu, 4),
                    }
                    for kind, (seconds, jobs, first, cpu) in plot_timings.items()
                },
                indent=1,
            )
            + "\n"
        )

    if plot_failures and not settings.continue_on_error:
        raise plot_failures[0][1]
    if failures or plot_failures:
        tap_lines.append("\n## Failures\n")
        for tap in failures:
            tap_lines.append(f"- {tap} (see {tap}/error.txt)")
        for label, exc in plot_failures:
            tap_lines.append(f"- plot rendering{f' ({label})' if label else ''}: {type(exc).__name__}: {exc}")

    if shard is not None:
        shard_path = reports_root / f"bundle_shard_{shard[0]}of{shard[1]}.md"
        shard_path.write_text("\n".join([f"# IR Bundle Report — shard {shard[0]}/{shard[1]}\n"] + tap_lines) + "\n")
        return shard_path
    index_path = reports_root / "bundle_report.md"
    index_path.write_text("\n".join(header_lines + tap_lines) + "\n")
    return index_path
