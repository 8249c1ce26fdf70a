"""
Continuous bundle watching (audio_analysis_tpu/report/watch.py): the
change -> render -> analyse -> repeat loop as a resident service.

`watch_bundle_runs` polls a recorder output directory (the C++
AnalysisRecorder writes `<root>/<timestamp>/{taps/*.wav, meta.json}`,
meta.json last, so its presence marks a complete bundle). Every new
complete bundle is analysed with the fused engine (run_bundle_report_engine)
on `device` and compared against the previously analysed bundle's
metrics, so each DSP iteration prints what it changed. Watch state (which
bundles were analysed, the last metrics path, failures) persists in
`<root>/.aa_watch_state.json` across restarts, and each analysed bundle
appends one JSON line to `<root>/watch_log.jsonl`.

A directory whose root itself is a bundle (meta.json at top level) is
watched for in-place re-recordings (mtime changes). With `plots=True` each
analysed bundle also gets the plot reports (report.bundle) in
`<reports_subdir>_plots`; a re-recorded bundle redraws only the taps whose
WAV changed since the last successful render (per-tap signatures in the
state file, keyed on the settings that change the figures).
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from audio_analysis_tpu_torch.report.compare import flagged_changes_in_index
from audio_analysis_tpu_torch.report.engine_report import (
    EngineBundleSettings,
    run_bundle_report_engine,
)

_STATE_NAME = ".aa_watch_state.json"


def _release_free_heap() -> None:
    """Return freed glibc arena pages to the OS after each analysed bundle.

    A resident watcher churns large short-lived host buffers every cycle
    (WAV decode chunks); glibc keeps the freed pages in its arenas, which
    reads as a slow climb of the resident set. malloc_trim(0) hands the
    reclaimable tail back between cycles. Best-effort: an absent or odd
    libc is ignored."""
    try:
        import ctypes

        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except Exception:  # noqa: BLE001 — strictly best-effort hygiene
        pass


@dataclasses.dataclass(frozen=True)
class WatchSettings:
    poll_seconds: float = 2.0
    engine: EngineBundleSettings = EngineBundleSettings()
    # auto-diff each bundle against the previously analysed one's metrics
    compare_to_previous: bool = True
    compare_threshold_pct: float = 1.0
    # stop after analysing this many bundles (None = run until interrupted)
    max_bundles: Optional[int] = None
    # give a bundle this long after meta.json appears for late tap flushes
    settle_seconds: float = 0.25
    # a failing bundle is retried this many times on later polls (IO
    # hiccups are transient) before being given up on
    max_failures_per_bundle: int = 3
    # also the full plot report per bundle (host-bound, seconds a tap; the
    # engine metrics and the diff stay the service output)
    plots: bool = False
    plot_processes: int = 0


def _tap_signatures(bundle: Path, meta: dict) -> Dict[str, str]:
    """Per-tap content identity ((size, mtime) of the tap WAV): the unit of
    figure reuse, as an unchanged tap's figures need no redraw."""
    sigs: Dict[str, str] = {}
    for tap in meta.get("taps", []):
        st = (bundle / "taps" / f"{tap}.wav").stat()
        sigs[tap] = f"{st.st_size}:{st.st_mtime_ns}"
    return sigs


def _bundle_signature(bundle: Path, meta: dict) -> str:
    """Identity of a bundle's content: meta mtime + per-tap (size, mtime).
    A re-recorded bundle (same dir, new audio) gets a new signature."""
    parts = [str(int(bundle.joinpath("meta.json").stat().st_mtime_ns))]
    parts.extend(f"{tap}:{sig}" for tap, sig in _tap_signatures(bundle, meta).items())
    return "|".join(parts)


def _complete_bundle_meta(bundle: Path) -> Optional[dict]:
    """meta.json parsed iff the bundle looks complete (meta is written last;
    still verify every listed tap exists)."""
    meta_path = bundle / "meta.json"
    if not meta_path.is_file():
        return None
    try:
        meta = json.loads(meta_path.read_text())
    except (OSError, ValueError):
        return None  # mid-write or corrupt; retry next poll
    taps = meta.get("taps", [])
    if not taps:
        return None
    if not all((bundle / "taps" / f"{t}.wav").is_file() for t in taps):
        return None
    return meta


def _discover_bundles(root: Path) -> List[Path]:
    if (root / "meta.json").is_file():
        return [root]
    return sorted(p for p in root.iterdir() if p.is_dir() and (p / "meta.json").is_file())


def _load_state(root: Path) -> dict:
    try:
        return json.loads((root / _STATE_NAME).read_text())
    except (OSError, ValueError):
        return {"analyzed": {}, "last_metrics": None}


def _save_state(root: Path, state: dict) -> None:
    (root / _STATE_NAME).write_text(json.dumps(state, indent=1) + "\n")


def _append_event_log(
    root: Path,
    bundle: Path,
    meta: dict,
    index: Path,
    flagged_changes: int,
    plot_counts: Optional[dict] = None,
) -> None:
    """One JSON line per analysed bundle in <root>/watch_log.jsonl: what
    ran, how long, what moved, how many audio chunks the device cache
    served, and with plots how many taps were drawn and reused.
    Best-effort: a log write must never kill the watcher."""
    event = {
        "ts": time.time(),
        "bundle": bundle.name,
        "taps": len(meta.get("taps", [])),
        "index": str(index),
        "flagged_changes": flagged_changes,
    }
    if plot_counts is not None:
        event.update(plot_counts)
    try:
        with open("/proc/self/status") as fh:
            event["rss_mb"] = round(int(fh.read().split("VmRSS:")[1].split()[0]) / 1024, 1)
    except (OSError, IndexError, ValueError):
        pass
    try:
        timings = json.loads((index.parent / "bundle_metrics.json").read_text())
        event["load_seconds"] = timings.get("load_seconds")
        event["compute_seconds"] = timings.get("compute_seconds")
        event["bundle_median_t30"] = timings.get("bundle_median_t30")
        phases = timings.get("phases", {})
        if "audio_chunks_reused" in phases:
            event["audio_chunks_reused"] = phases["audio_chunks_reused"]
            event["audio_chunks_uploaded"] = phases["audio_chunks_uploaded"]
    except (OSError, ValueError):
        pass
    try:
        with (root / "watch_log.jsonl").open("a") as fh:
            fh.write(json.dumps(event) + "\n")
    except OSError:
        pass


def _render_plots(
    bundle: Path,
    settings: WatchSettings,
    tap_sigs: Dict[str, str],
    previous_sigs: Optional[dict],
    first_render: bool,
    device: "str | torch.device",
) -> dict:
    """The plot reports of one bundle into `<reports_subdir>_plots`: every
    tap the first time (a resume recovers a partial first render), after
    that only the taps whose WAV changed, and any tap whose PNG set is
    incomplete. Returns the rendered and reused tap counts."""
    from audio_analysis_tpu_torch.report.bundle import BundleRunSettings, _report_complete, run_bundle_report
    from audio_analysis_tpu_torch.report.report import ReportSettings

    subdir = f"{settings.engine.reports_subdir}_plots"
    render_only = (
        None if previous_sigs is None else tuple(t for t, sig in tap_sigs.items() if previous_sigs.get(t) != sig)
    )
    complete_before = {t: _report_complete(bundle / subdir / t / f"{t}_report.md") for t in tap_sigs}
    run_bundle_report(
        bundle,
        BundleRunSettings(
            reports_subdir=subdir,
            resume=first_render,
            render_only_taps=render_only,
            report_settings=ReportSettings(
                plot_processes=settings.plot_processes,
                common_use_mono_downmix_for_stereo=settings.engine.use_mono_downmix_for_stereo,
            ),
        ),
        device,
    )
    if render_only is None:
        rendered = len(tap_sigs)
    else:
        rendered = sum(1 for t in tap_sigs if t in render_only or not complete_before[t])
    return {"figures_rendered_taps": rendered, "figures_skipped_taps": len(tap_sigs) - rendered}


def watch_bundle_runs(
    watch_root: str | Path,
    settings: Optional[WatchSettings] = None,
    log: Callable[[str], None] = print,
    stop: Optional[Callable[[], bool]] = None,
    device: "str | torch.device" = "cuda",
) -> List[Path]:
    """Poll `watch_root` for complete bundles and analyse each new (or
    changed) one with the fused engine on `device`; returns the index paths
    written. `stop()` is checked every poll for cooperative shutdown;
    `settings.max_bundles` bounds the run.
    """
    if settings is None:
        settings = WatchSettings()
    root = Path(watch_root)
    if not root.is_dir():
        raise ValueError(f"watch root {root} is not a directory")

    state = _load_state(root)
    analyzed: Dict[str, str] = dict(state.get("analyzed", {}))
    failures: Dict[str, dict] = dict(state.get("failures", {}))
    # per-tap WAV signatures of each bundle's last successful figure
    # render, valid only for the settings that change the figures' content
    # (plot_processes changes where they are drawn, not what)
    plot_settings_fp = repr(("mono", settings.engine.use_mono_downmix_for_stereo))
    plot_sigs: Dict[str, dict] = (
        dict(state.get("plot_sigs", {})) if state.get("plot_sigs_settings") == plot_settings_fp else {}
    )
    last_metrics: Optional[str] = state.get("last_metrics")
    written: List[Path] = []

    def save_state() -> None:
        # any other key of the state file is written back unchanged
        _save_state(
            root,
            {
                **state,
                "analyzed": analyzed,
                "failures": failures,
                "last_metrics": last_metrics,
                "plot_sigs": plot_sigs,
                "plot_sigs_settings": plot_settings_fp,
            },
        )

    log(f"watching {root} (poll {settings.poll_seconds:g}s; Ctrl-C to stop)")
    while True:
        if stop is not None and stop():
            break
        progressed = False
        for bundle in _discover_bundles(root):
            # the recorder may replace files under us at any point: a
            # stat/read race means "not ready, retry next poll"
            try:
                meta = _complete_bundle_meta(bundle)
                if meta is None:
                    continue
                if analyzed.get(str(bundle)) == _bundle_signature(bundle, meta):
                    continue
                time.sleep(settings.settle_seconds)
                # (re-)sign after the settle window, so a tap flushed during
                # it does not force a duplicate re-analysis next poll
                meta = _complete_bundle_meta(bundle)
                if meta is None:
                    continue
                signature = _bundle_signature(bundle, meta)
            except OSError:
                continue
            if analyzed.get(str(bundle)) == signature:
                continue
            past = failures.get(str(bundle), {})
            if (
                past.get("signature") == signature
                and past.get("count", 0) >= settings.max_failures_per_bundle
            ):
                continue  # gave up on this content (logged when it happened)
            engine = settings.engine
            if settings.compare_to_previous and last_metrics:
                engine = dataclasses.replace(
                    engine,
                    compare_to=last_metrics,
                    compare_threshold_pct=settings.compare_threshold_pct,
                )
            try:
                index = run_bundle_report_engine(bundle, engine, device)
            except Exception as exc:  # noqa: BLE001 — keep watching
                count = (past.get("count", 0) if past.get("signature") == signature else 0) + 1
                failures[str(bundle)] = {"signature": signature, "count": count}
                gave_up = count >= settings.max_failures_per_bundle
                log(
                    f"FAILED {bundle.name} (attempt {count}/"
                    f"{settings.max_failures_per_bundle}"
                    f"{', giving up' if gave_up else ', will retry'}): "
                    f"{type(exc).__name__}: {exc}"
                )
                save_state()
                continue
            plot_counts = None
            if settings.plots:
                try:
                    tap_sigs = _tap_signatures(bundle, meta)
                except OSError:
                    continue  # the recorder replaced a tap mid-poll; retry
                try:
                    plot_counts = _render_plots(bundle, settings, tap_sigs, plot_sigs.get(str(bundle)),
                                                str(bundle) not in analyzed, device)
                    plot_sigs[str(bundle)] = tap_sigs
                except Exception as exc:  # noqa: BLE001 — the engine's retry budget
                    # the bundle stays un-analysed, so a transient plot
                    # failure is retried next poll
                    count = (past.get("count", 0) if past.get("signature") == signature else 0) + 1
                    failures[str(bundle)] = {"signature": signature, "count": count}
                    gave_up = count >= settings.max_failures_per_bundle
                    log(
                        f"plot report FAILED for {bundle.name} (attempt {count}/"
                        f"{settings.max_failures_per_bundle}"
                        f"{', keeping the metrics-only result' if gave_up else ', will retry'}): "
                        f"{type(exc).__name__}: {exc}"
                    )
                    save_state()
                    if not gave_up:
                        continue
                    # out of retries: keep the engine analysis (metrics, diff)

            written.append(index)
            analyzed[str(bundle)] = signature
            failures.pop(str(bundle), None)
            last_metrics = str(index.parent / "bundle_metrics.json")
            save_state()

            num_changes = flagged_changes_in_index(index)
            suffix = f"  ({num_changes} changes vs previous)" if num_changes else ""
            log(f"analysed {bundle.name}: {len(meta.get('taps', []))} taps -> {index}{suffix}")
            _release_free_heap()
            _append_event_log(root, bundle, meta, index, num_changes, plot_counts)
            progressed = True
            if settings.max_bundles is not None and len(written) >= settings.max_bundles:
                return written
        if not progressed:
            if stop is not None and stop():
                break
            time.sleep(settings.poll_seconds)
    return written
