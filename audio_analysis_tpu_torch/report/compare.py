"""
Run-to-run bundle comparison (audio_analysis_tpu/report/compare.py): the
regression-detection step of the change -> render -> analyse -> repeat
loop. The engine bundle runner diffs the machine-readable metrics of two
runs (reports/bundle_metrics.json) and appends a deterministic "Changes vs
previous" section to the index, so a DSP change that moves any headline
metric past a threshold is called out by name. The text is byte-identical
to the JAX package's for the same two metrics files.

Host-side dict/ndarray work only; no device involvement.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

# headline metrics worth flagging (key -> short axis label for dims beyond
# (tap, channel): band index, etc.). Diagnostic fields (slopes, r2, fit
# windows, frame counts) and per-bin clouds (modal_rt60, 240 bins) are
# deliberately excluded — they move with every noise-floor wiggle.
_COMPARED_METRICS: tuple = (
    "t30_rt60",
    "t20_rt60",
    "edt_rt60",
    "early10_time",
    "band_t30_rt60",
    "band_t20_rt60",
    "band_edt_rt60",
    "fr_peak_hz",
    "fr_centroid_hz",
    "gd_median",
    "gd_p10",
    "gd_p90",
    "diff_median_autocorr",
    "diff_median_echo_density",
    "diff_median_corr0",
    "diff_median_iacc",
    "modal_median_rt60",
    "modal_p90_rt60",
    "modal_max_rt60",
    "modal_count",
    "stft_global_max_db",
)
# validity flips are regressions even when the value column is excluded
_OK_FLAGS: tuple = (
    "t30_ok",
    "t20_ok",
    "edt_ok",
    "early10_ok",
    "band_t30_ok",
    "band_t20_ok",
    "band_edt_ok",
)


def load_bundle_metrics(path: str | Path) -> dict:
    """Accepts a bundle_metrics.json file, a reports dir containing one, or
    a bundle root (uses <root>/reports/bundle_metrics.json)."""
    p = Path(path)
    candidates = [p, p / "bundle_metrics.json", p / "reports" / "bundle_metrics.json"]
    for candidate in candidates:
        if candidate.is_file():
            # parse_constant default accepts NaN/Infinity, matching the
            # writer (engine_report.py metrics dump)
            return json.loads(candidate.read_text())
    raise FileNotFoundError(
        f"No bundle_metrics.json found at {p} (tried: "
        + ", ".join(str(c) for c in candidates)
        + ") — run `bundle --no-plots` on the previous bundle first"
    )


def _cell_label(tap: str, channel: str, key: str, idx: tuple) -> str:
    suffix = "".join(f"[{i}]" for i in idx)
    return f"{tap} [{channel}] {key}{suffix}"


def _fmt(value: float) -> str:
    return f"{value:.4f}"


def format_bundle_comparison(
    current: dict,
    previous: dict,
    threshold_pct: float = 1.0,
    previous_label: str = "previous",
    max_lines: int = 200,
    min_abs_change: float = 1e-3,
) -> str:
    """Deterministic markdown section listing every headline-metric change
    >= threshold_pct (relative, symmetric denominator guard) and every
    ok-flag flip, per tap/channel/band; plus taps present in only one run
    and metric families that disappeared. `min_abs_change` suppresses
    relative blowups on near-zero values (sub-milli-unit jitter on a
    ~0 dB or ~0 s metric is numeric noise, not a regression).
    """
    cur_taps: List[str] = list(current.get("taps", []))
    prev_taps: List[str] = list(previous.get("taps", []))
    cur_metrics: Dict[str, list] = current.get("metrics", {})
    prev_metrics: Dict[str, list] = previous.get("metrics", {})
    cur_channels: List[str] = list(current.get("channels", []))
    prev_channels: List[str] = list(previous.get("channels", []))

    lines: List[str] = [f"\n## Changes vs {previous_label} (threshold {threshold_pct:g}%)\n"]

    added = [t for t in cur_taps if t not in prev_taps]
    removed = [t for t in prev_taps if t not in cur_taps]
    for tap in added:
        lines.append(f"- {tap}: new tap (not in previous run)")
    for tap in removed:
        lines.append(f"- {tap}: removed (was in previous run)")

    if cur_channels != prev_channels:
        lines.append(
            f"- channel layout changed: {prev_channels} -> {cur_channels} "
            "(per-metric comparison skipped)"
        )
        return "\n".join(lines) + "\n"

    shared = [t for t in cur_taps if t in prev_taps]
    prev_index = {t: prev_taps.index(t) for t in shared}
    changes: List[str] = []
    for key in _COMPARED_METRICS + _OK_FLAGS:
        if key in prev_metrics and key not in cur_metrics:
            # a whole metric family vanished (block disabled, key renamed)
            # — that IS a regression, not a skip
            changes.append(f"- {key}: missing from current run (was present)")
            continue
        if key not in cur_metrics or key not in prev_metrics:
            continue
        cur_arr = np.asarray(cur_metrics[key])
        prev_arr = np.asarray(prev_metrics[key])
        if cur_arr.shape[1:] != prev_arr.shape[1:]:
            changes.append(f"- {key}: shape changed {prev_arr.shape} -> {cur_arr.shape}")
            continue
        is_flag = key in _OK_FLAGS
        for tap in shared:
            b_cur = cur_taps.index(tap)
            b_prev = prev_index[tap]
            cur_tap = np.atleast_1d(cur_arr[b_cur])
            prev_tap = np.atleast_1d(prev_arr[b_prev])
            # (C, ...) per tap; corr0/iacc are stereo-joint (no channel dim)
            per_channel = cur_tap.shape[:1] == (len(cur_channels),)
            for idx in np.ndindex(cur_tap.shape):
                new, old = cur_tap[idx], prev_tap[idx]
                channel = cur_channels[idx[0]] if per_channel else "stereo"
                # stereo-joint scalars (corr0/IACC) need no index suffix
                rest = idx[1:] if per_channel else (idx if cur_tap.size > 1 else ())
                if is_flag:
                    if bool(new) != bool(old):
                        changes.append(
                            f"- {_cell_label(tap, channel, key, rest)}: "
                            f"{bool(old)} -> {bool(new)}"
                        )
                    continue
                new_f, old_f = float(new), float(old)
                if math.isnan(new_f) and math.isnan(old_f):
                    continue
                if math.isnan(new_f) != math.isnan(old_f):
                    changes.append(
                        f"- {_cell_label(tap, channel, key, rest)}: "
                        f"{_fmt(old_f)} -> {_fmt(new_f)}"
                    )
                    continue
                if abs(new_f - old_f) < min_abs_change:
                    continue
                denom = max(abs(old_f), abs(new_f), 1e-12)
                rel_pct = abs(new_f - old_f) / denom * 100.0
                if rel_pct >= threshold_pct:
                    sign = "+" if new_f >= old_f else "-"
                    changes.append(
                        f"- {_cell_label(tap, channel, key, rest)}: "
                        f"{_fmt(old_f)} -> {_fmt(new_f)} ({sign}{rel_pct:.1f}%)"
                    )

    if len(changes) > max_lines:
        dropped = len(changes) - max_lines
        changes = changes[:max_lines]
        changes.append(f"- ... {dropped} further changes above threshold omitted")
    if changes:
        lines.extend(changes)
    elif not added and not removed:
        lines.append("No changes above threshold.")
    return "\n".join(lines) + "\n"


def count_flagged_in_text(text: str) -> int:
    """Number of flagged lines in 'Changes vs' section text (changed
    metrics, ok flips, added/removed taps, missing metric families; an
    unavailable comparison counts as one). THE single parser — the CI
    gates, the watch log and the compare subcommand all count through it,
    so they agree by construction."""
    count = 0
    in_section = False
    for line in text.splitlines():
        if line.startswith("## "):
            in_section = line.startswith("## Changes vs")
            continue
        if in_section and (line.startswith("- ") or line.startswith("Comparison unavailable")):
            count += 1
    return count


def flagged_changes_in_index(index_path: str | Path) -> int:
    """`count_flagged_in_text` over an index file."""
    return count_flagged_in_text(Path(index_path).read_text())


def index_has_flagged_changes(index_path: str | Path) -> bool:
    """Used by `bundle --compare --fail-on-change` as a CI regression gate."""
    return flagged_changes_in_index(index_path) > 0


def compare_section_for_index(
    current_metrics: dict,
    previous_path: str | Path,
    threshold_pct: float,
) -> Optional[str]:
    """Convenience wrapper for the bundle runner: load + format, surfacing
    load problems as a markdown note instead of failing the whole run."""
    try:
        previous = load_bundle_metrics(previous_path)
    except (OSError, ValueError, FileNotFoundError) as exc:
        return (
            f"\n## Changes vs previous\n\n"
            f"Comparison unavailable: {type(exc).__name__}: {exc}\n"
        )
    return format_bundle_comparison(
        current_metrics,
        previous,
        threshold_pct=threshold_pct,
        previous_label=f"`{previous_path}`",
    )
