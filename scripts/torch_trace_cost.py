#!/usr/bin/env python3
"""
What the port's tracing costs, on one NVIDIA GPU and its host. Run from the
repository root:

    python3 scripts/torch_trace_cost.py [--rounds 2] [--replays 20]

- markers: the engine step of one 8-tap chunk (2 x 1,155,072 PCM16 samples
  a tap, the bundle's chunk) captured into a CUDA graph twice, with its
  block markers (ops/marker.py) and with `marker.mark` made a no-op, at
  three-band and third-octave settings; each graph replayed `--replays`
  times between CUDA events, in turns (markers, none, none, markers) for
  `--rounds` rounds: device ms a replay. Under torch.profiler, the
  markers' own device time (us a marker) from one replay.
- spans: utils/timing.py `span` on this host, us a span: outside any
  profiler session (with and without a `phases` key, beside the pair of
  perf_counter calls it replaced) and inside a CPU+CUDA session.
- spans a call: the `aa.*` spans of one warm `run_bundle_report_engine`
  call over a 16-tap bundle (2 chunks of 8), its taps re-stamped first so
  that every chunk decodes, by name.

Prints the card's name and power limit first and one JSON line last. Needs
CUDA; no result without it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from dataclasses import replace
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SR = 48_000
N = 1_155_072  # the 24 s tap padded to the decoder's multiple of 4096
TAPS = 8


def chunk(torch, dev):
    """One chunk of decaying noise with a direct impulse, PCM16, seed 0."""
    g = torch.Generator(device=dev).manual_seed(0)
    t = torch.arange(N, device=dev, dtype=torch.float32) / SR
    x = 0.3 * torch.randn(TAPS, 2, N, device=dev, generator=g) * 10.0 ** (-3.0 * t / 1.2)
    x[:, :, 480] = 0.9
    pcm = (x.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
    return pcm, torch.full((TAPS,), N - 3072, dtype=torch.int32, device=dev)


def marker_ab(torch, dev, rounds: int, replays: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from audio_analysis_tpu_torch.engine import EngineConfig, graphs
    from audio_analysis_tpu_torch.engine import batch as batch_module
    from audio_analysis_tpu_torch.ops import marker

    x, lengths = chunk(torch, dev)
    real_mark = marker.mark
    out = {}
    for mode in ("three", "third"):
        config = replace(EngineConfig(), band_mode=mode)
        caches = {}
        for variant in ("markers", "none"):
            marker.mark = real_mark if variant == "markers" else (lambda block, device: None)
            cache = graphs.StepGraphs(min_calls_ahead=0)
            cache.run(batch_module._analyze_batch_flat, x, lengths, config)  # eager, then captured
            caches[variant] = cache
        marker.mark = real_mark
        ms = {"markers": [], "none": []}
        for _r in range(rounds):
            for variant in ("markers", "none", "none", "markers"):
                cache = caches[variant]
                for _ in range(3):
                    cache.run(batch_module._analyze_batch_flat, x, lengths, config)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(replays):
                    cache.run(batch_module._analyze_batch_flat, x, lengths, config)
                end.record()
                end.synchronize()
                ms[variant].append(start.elapsed_time(end) / replays)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            caches["markers"].run(batch_module._analyze_batch_flat, x, lengths, config)
            torch.cuda.synchronize()
        marks = [e.duration_ns() * 1e-3 for e in prof.profiler.kineto_results.events()
                 if e.device_type().name == "CUDA" and e.name().startswith("aa_mark_")]
        for cache in caches.values():
            cache.clear()
        with_m, without = statistics.median(ms["markers"]), statistics.median(ms["none"])
        out[mode] = {"replay_ms_markers": ms["markers"], "replay_ms_none": ms["none"],
                     "median_markers_ms": with_m, "median_none_ms": without,
                     "markers_over_none": with_m / without - 1.0,
                     "markers_a_replay": len(marks), "marker_us": marks}
    return out


def span_costs(torch, dev) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from audio_analysis_tpu_torch.utils.timing import span

    def per_span(fn, n):
        t0 = time.perf_counter()
        fn(n)
        return (time.perf_counter() - t0) / n * 1e6

    def bare(n):
        for _ in range(n):
            with span("aa.cost"):
                pass

    def with_phases(n):
        ph = {}
        for _ in range(n):
            with span("aa.cost", ph, "k"):
                pass

    def pair(n):
        ph = {}
        for _ in range(n):
            t = time.perf_counter()
            ph["k"] = ph.get("k", 0.0) + (time.perf_counter() - t)

    out = {k: [per_span(f, 100_000) for _ in range(3)]
           for k, f in (("idle_us", bare), ("idle_phases_us", with_phases), ("perf_counter_pair_us", pair))}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out["traced_us"] = [per_span(bare, 10_000) for _ in range(3)]
    return out


def spans_a_call(torch, dev) -> dict:
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from audio_analysis_tpu_torch.engine import EngineConfig
    from audio_analysis_tpu_torch.io import native, write_bundle
    from audio_analysis_tpu_torch.report.engine_report import EngineBundleSettings, run_bundle_report_engine

    if not native.ensure_built():
        return {"error": "no native decoder (make -C cpp)"}
    n = 1 << 17
    rng = np.random.default_rng(0)
    t = np.arange(n) / SR
    taps = {}
    for i in range(16):
        x = 0.3 * rng.standard_normal((n, 2)) * (10.0 ** (-3.0 * t / 1.2))[:, None]
        x[480] = 0.9
        taps[f"tap{i:02d}"] = x.astype(np.float32)
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        root = write_bundle(Path(tmp) / "b", taps, SR)
        settings = EngineBundleSettings(config=replace(EngineConfig(), band_mode="three"))
        for _ in range(3):  # eager, captured, replayed
            run_bundle_report_engine(root, settings, dev)
        # a new mtime on every tap, as a re-recording leaves it: the device
        # audio cache serves no chunk, every chunk decodes and uploads
        stamp = time.time_ns()
        for wav in sorted((root / "taps").glob("*.wav")):
            os.utime(wav, ns=(stamp, stamp))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            run_bundle_report_engine(root, settings, dev)
            torch.cuda.synchronize()
    names = Counter(e.name() for e in p.profiler.kineto_results.events()
                    if e.device_type().name == "CPU" and e.name().startswith("aa."))
    return {"taps": 16, "chunks": 2, "by_name": dict(sorted(names.items())), "total": sum(names.values())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--replays", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_trace_cost: needs CUDA", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    result = {"card": card, "torch": torch.__version__, "markers": marker_ab(torch, dev, args.rounds, args.replays),
              "spans": span_costs(torch, dev), "spans_a_call": spans_a_call(torch, dev)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
