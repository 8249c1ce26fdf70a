"""
One run of one cell: set-up, the measured window (or the traced window),
the check of what the window produced, and the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` `breakdown`,
and last `check`: each number compared, with its limit). The numbers
compared are also the last lines of standard error.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List

from benchlib import device as dev
from benchlib import spec

WINDOW_SPAN = "benchmark_window"
CALL_SPAN = "benchmark_call"


class RunFailed(Exception):
    """The run cannot give a result; nothing is printed on standard output."""


def workdir_for(cell: str, root: Path = spec.ROOT) -> Path:
    return root / "build" / "benchmark_runs" / cell


def prepare_program(torch, device) -> None:
    """The native decoder and the kernel library, built into the checkout's
    fixed build directories on a checkout's first run, loaded after."""
    from audio_analysis_tpu_torch.io import native

    if not native.ensure_built():
        raise RunFailed("the native decoder (cpp/build/libaudioio.so) is unavailable: "
                        "the benchmark measures the PCM16 fast path only")
    if torch.device(device).type == "cuda":
        from audio_analysis_tpu_torch import _build

        _build.library()


def measured_window(entry, seconds: float, first_index: int) -> tuple:
    """Closed loop, one client: calls back to back until `seconds` have
    passed; the window ends when the last call returns."""
    records: List[dict] = []
    t0 = time.perf_counter()
    i = first_index
    while True:
        c0 = time.perf_counter()
        rec = entry.call(i)
        rec["t0"], rec["t1"] = c0 - t0, time.perf_counter() - t0
        records.append(rec)
        i += 1
        if rec["t1"] >= seconds:
            break
    return records, time.perf_counter() - t0


def traced_window(torch, entry, seconds: float, first_index: int, max_calls: int):
    """The window under torch.profiler, each call in a span, the mix's
    program functions wrapped in spans of their own; at most `max_calls`
    calls, so that reading the trace stays short."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchlib import trace

    records: List[dict] = []
    with trace.program_spans(entry.trace_targets()) as named:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW_SPAN):
                t0 = time.perf_counter()
                i = first_index
                while len(records) < max_calls:
                    c0 = time.perf_counter()
                    with record_function(CALL_SPAN):
                        rec = entry.call(i)
                    rec["t0"], rec["t1"] = c0 - t0, time.perf_counter() - t0
                    records.append(rec)
                    i += 1
                    if rec["t1"] >= seconds:
                        break
                torch.cuda.synchronize()
                window_s = time.perf_counter() - t0
    view = trace.read_profile(prof, WINDOW_SPAN, [CALL_SPAN] + named)
    return records, window_s, view


def read_metrics(cell, ctx) -> Dict[str, dict]:
    metrics = {}
    wanted = cell.per_layer if ctx.traced else cell.end_to_end
    for m in wanted:
        value = spec.metric_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return metrics


def check_numbers(cell, judged: dict) -> Dict[str, dict]:
    limits = cell.limits["limits"]
    worst = judged["worst"]
    unbound = sorted(set(worst.value) - set(limits))
    if unbound:
        raise spec.SpecError(f"{cell.name}: no limit for {', '.join(unbound)} in benchmark/limits/")
    return {name: {"value": float(worst.value[name]), "limit": float(limits[name])} for name in limits}


def run(workload: str, seed: int, seconds: float, traced: bool, t_start: float,
        device_name: str = "cuda", scale: dict | None = None, need_card: bool = True,
        root: Path = spec.ROOT, workdir: Path | None = None) -> dict:
    cell = spec.resolve(workload, root)
    dev.cache_environment(root)
    import torch

    parts = {"imports": time.perf_counter() - t_start}
    device_block = {"platform": "cpu", "kind": "cpu", "count": 1}
    if need_card:
        device_block = dev.require_cards(torch, int(cell.workload["chips"]))
        device_block["power_limit"] = dev.power_limit()
    prepare_program(torch, device_name)
    parts["card_and_builds"] = time.perf_counter() - t_start - sum(parts.values())
    on_card = torch.device(device_name).type == "cuda"

    entry = spec.entry(cell.mix["entry"]).Entry(cell, seed, device_name, workdir or workdir_for(workload, root), scale)
    entry.setup()
    parts.update(entry.setup_parts)
    # what set-up wrote reaches the disk now, not as writeback in the window
    t0 = time.perf_counter()
    os.sync()
    parts["sync"] = time.perf_counter() - t0
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    first = int(getattr(entry, "warm_calls", 0))
    before = entry.counters()
    view = None
    if traced:
        if not on_card:
            raise RunFailed("a traced run needs the card")
        records, window_s, view = traced_window(torch, entry, seconds, first, int(cell.mix["trace_calls"]))
    else:
        records, window_s = measured_window(entry, seconds, first)
    after = entry.counters()
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0

    ctx = SimpleNamespace(cell=cell, entry=entry, records=records, window_s=window_s, setup_s=setup_s,
                          peak_alloc_bytes=peak, trace=view, traced=traced, counters=(before, after),
                          ops=sum(r["ops"] for r in records if "error" not in r))
    metrics = read_metrics(cell, ctx)

    entry.release()
    judged = entry.judge(records)
    failed = judged["failed"] + sum(r["ops"] for r in records if "error" in r)
    check = check_numbers(cell, judged)
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in check.values())

    device_block["memory_peak_bytes"] = peak
    if traced:
        device_block["busy_s"] = view.busy_s()
        device_block["window_s"] = view.window_s()
    result = {"correct": bool(correct), "attempted": int(sum(r["ops"] for r in records)), "failed": int(failed),
              "metrics": metrics, "device": device_block}
    if traced:
        result["breakdown"] = view.breakdown()
    result["check"] = check
    phases = [entry.phases(r) for r in records]
    notes = {"where": {name: judged["worst"].where[name] for name in check},
             "errors": [r["error"] for r in records if "error" in r][:5],
             "walls": [r["t1"] - r["t0"] for r in records], "setup_parts": parts,
             "phase_means": {k: sum(p[k] for p in phases) / len(phases) for k in phases[0]
                             if all(isinstance(p.get(k), (int, float)) for p in phases)} if phases else {}}
    return result, notes


def emit(result: dict, notes: dict) -> None:
    """Diagnostics, then the numbers compared as the last lines of standard
    error; the result as the last line of standard output."""
    where = notes["where"]
    print("set-up parts (s): " + " ".join(f"{k} {v:.3f}" for k, v in notes["setup_parts"].items()), file=sys.stderr)
    print("call walls (s): " + " ".join(f"{w:.4f}" for w in notes["walls"]), file=sys.stderr)
    print("program phases, mean a call: " + " ".join(f"{k} {v:.4f}" for k, v in notes["phase_means"].items()),
          file=sys.stderr)
    for err in notes["errors"]:
        print(f"call failed: {err}", file=sys.stderr)
    print(f"correct: {result['correct']} failed: {result['failed']} of {result['attempted']}", file=sys.stderr)
    for name, c in result["check"].items():
        print(f"{name}: {c['value']!r} limit {c['limit']!r} ({where.get(name, '')})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv: List[str], t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result, notes = run(args.workload, args.seed, args.seconds, bool(args.trace), t_start)
    except (RunFailed, spec.SpecError, ImportError) as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2
    banned = dev.banned_modules()
    if banned:
        print(f"benchmark: the run loaded {', '.join(banned)}; no result", file=sys.stderr)
        return 3
    emit(result, notes)
    return 0
