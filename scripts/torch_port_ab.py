#!/usr/bin/env python3
"""
Time the port's generator and report paths of two trees side by side on
one NVIDIA GPU, in turns. Run from the repository root:

    python3 scripts/torch_port_ab.py --tree parent=<path to another checkout> [--rounds 2] [--reps 5]

Trees: this checkout ("tree") and each --tree LABEL=PATH (for example the
parent commit unpacked with `git archive` into a directory that .gitignore
lists). Each measurement runs in a fresh process started in its tree, so
each tree builds and loads its own kernels; the trees run in order and then
in reverse, `--rounds` times (tree, parent, parent, tree for two rounds).
Every process measures on the same inputs, made from seed 0: a stereo
2^20-sample decaying-noise tap at 48 kHz written under build/port_ab/.

Per process, host clock around work that ends in a synchronize:
  gen_karplus_4k: `gen karplus_pluck --freq 4000` through the gen CLI entry
      on the card, one cold run and `--reps` warm ones (s);
  pooling: ops.display.pooled_log_freq_image on the tap's 4096-point dB
      STFT plane (the report's call), `--reps` calls after one (ms); its
      device part, the tree's K4 wrapper `ops.display._pooled_image` on the
      same plane (ms), and its device time by kernel under torch.profiler
      (us a call); and the rest of the call, the int16 image's copy to the
      host and the host's work on it, as the call's median less the
      wrapper's (ms);
  report: run_report_from_wav_file on the tap with its render jobs recorded
      (not drawn, as on a host without matplotlib), one cold and `--reps`
      warm runs (s), and the cold run's time by block (its timing footer).
Prints the card's name and power limit first and one JSON line last. Needs
CUDA; no result without it.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "port_ab"
SR = 48_000
N = 1 << 20


def write_tap(path: Path) -> None:
    """A stereo decaying-noise IR (RT60 about 1.2 s) with a direct impulse,
    PCM16, from seed 0."""
    import numpy as np
    from scipy.io import wavfile

    rng = np.random.default_rng(0)
    t = np.arange(N) / SR
    x = 0.3 * rng.standard_normal((N, 2)) * (10.0 ** (-3.0 * t / 1.2))[:, None]
    x[480] = 0.9
    wavfile.write(path, SR, (np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16))


def device_us_by_name(torch, fn, reps: int) -> dict:
    """Device microseconds a call of fn spends in each kernel or copy, by
    name (the first 48 characters), from torch.profiler over `reps` calls;
    "busy" is their sum."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            name = e.name[:48]
            by_name[name] = by_name.get(name, 0.0) + (e.time_range.end - e.time_range.start) / reps
    return {"busy": sum(by_name.values()), **by_name}


def worker(tap: Path, out_dir: Path, reps: int) -> dict:
    """The measurements of one process, in the tree it was started in."""
    import numpy as np
    import torch

    from _render_jobs import RecordingPlotWorker
    from audio_analysis_tpu_torch.analyses._common import FileDsp
    from audio_analysis_tpu_torch.cli.gen_cli import main as gen_main
    from audio_analysis_tpu_torch.ops import display
    from audio_analysis_tpu_torch.ops import stft as stft_ops
    from audio_analysis_tpu_torch.report.report import ReportSettings, run_report_from_wav_file

    dev = torch.device("cuda", 0)

    def wall(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def gen():
        gen_main(["--output-dir", str(out_dir / "gen"), "--device", "cuda", "karplus_pluck", "--freq", "4000"])

    result = {"gen_karplus_4k_cold_s": wall(gen)}
    result["gen_karplus_4k_warm_s"] = [wall(gen) for _ in range(reps)]

    dsp = FileDsp.from_wav_file(tap, False, dev)
    _, seg_lens = dsp.aligned_host_meta(True, 0.0, None)
    plane = dsp.stft_db(True, 0.0, None, 4096, 512, True, -120.0).mag_db
    frames = np.array([stft_ops.num_frames_static(int(n), 4096, 512) for n in seg_lens], np.int64)
    args = (frames, 4096, SR, 20.0, 20_000.0)
    display.pooled_log_freq_image(plane, *args)
    result["pooling_call_ms"] = [1e3 * wall(lambda: display.pooled_log_freq_image(plane, *args)) for _ in range(reps)]
    col_pool = -(-int(frames.max()) // 1200) if int(frames.max()) > 1800 else 1
    i0, i1 = display.freq_selection(4096, SR, 20.0, 20_000.0)
    key = (4096, SR, i0, i1, 20.0, 20_000.0, 720)
    nf = torch.from_numpy(frames).to(dev)
    result["pooling_wrapper_ms"] = [1e3 * wall(lambda: display._pooled_image(plane, nf, key, col_pool))
                                    for _ in range(reps)]
    result["pooling_copy_and_host_ms"] = (statistics.median(result["pooling_call_ms"])
                                          - statistics.median(result["pooling_wrapper_ms"]))
    result["pooling_wrapper_device_us"] = device_us_by_name(
        torch, lambda: display._pooled_image(plane, nf, key, col_pool), reps)

    def report(settings=ReportSettings()):
        return run_report_from_wav_file(tap, out_dir / "report" / "tap", settings, RecordingPlotWorker(), dev)

    cold = []
    result["report_cold_s"] = wall(lambda: cold.append(report(ReportSettings(include_timing_footer=True))))
    footer = Path(cold[0].summary_markdown_path).read_text()
    result["report_cold_blocks_s"] = {k: float(v) for k, v in re.findall(r"\|\s*([a-z_]+)\s*\|\s*([0-9.]+)", footer)}
    result["report_warm_s"] = [wall(report) for _ in range(reps)]
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], metavar="LABEL=PATH",
                    help="another checkout to time beside this one")
    ap.add_argument("--rounds", type=int, default=2, help="passes over the trees, alternating their order")
    ap.add_argument("--reps", type=int, default=5, help="warm repetitions of each measurement a process")
    ap.add_argument("--worker", nargs=2, metavar=("TAP", "OUT_DIR"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        sys.path[:0] = [str(Path.cwd()), str(Path.cwd() / "tests")]
        print(json.dumps(worker(Path(args.worker[0]), Path(args.worker[1]), args.reps)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("torch_port_ab.py: needs an NVIDIA GPU with CUDA", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    trees = [("tree", REPO)] + [(label, Path(path).resolve()) for label, path in (t.split("=", 1) for t in args.tree)]
    OUT.mkdir(parents=True, exist_ok=True)
    tap = OUT / "tap.wav"
    write_tap(tap)
    runs = {label: [] for label, _ in trees}
    for r in range(args.rounds):
        for label, root in (trees if r % 2 == 0 else trees[::-1]):
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--reps", str(args.reps), "--worker", str(tap),
                 str(OUT / label / str(r))],
                cwd=root, capture_output=True, text=True, timeout=900,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"{label} round {r} failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
            one = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[label].append(one)
            print(f"{label} round {r}: gen 4 kHz warm {min(one['gen_karplus_4k_warm_s']):.4f}-"
                  f"{max(one['gen_karplus_4k_warm_s']):.4f} s; pooling call {min(one['pooling_call_ms']):.3f}-"
                  f"{max(one['pooling_call_ms']):.3f} ms; report warm {min(one['report_warm_s']):.4f}-"
                  f"{max(one['report_warm_s']):.4f} s", flush=True)
    summary = {}
    for label, rs in runs.items():
        # one entry per measurement; each part of a dict (a block of the
        # cold report, a kernel of the wrapper) is one too
        flat = [{**{k: v for k, v in r.items() if not isinstance(v, dict)},
                 **{f"{k}[{part}]": v for k, d in r.items() if isinstance(d, dict) for part, v in d.items()}}
                for r in rs]
        summary[label] = {}
        for key in dict.fromkeys(k for r in flat for k in r):
            values = [v for r in flat if key in r for v in (r[key] if isinstance(r[key], list) else [r[key]])]
            summary[label][key] = {"median": statistics.median(values), "min": min(values), "max": max(values)}
    print(json.dumps({"card": card, "runs": runs, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
