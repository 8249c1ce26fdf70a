#!/usr/bin/env python3
"""
Smoke run of the PyTorch/CUDA port (audio_analysis_tpu_torch) on one NVIDIA
GPU (Hopper, sm_90a). Run from the repository root:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):
  1. build the CUDA kernels from csrc/ with nvcc;
  2. kernel vs plain: each kernel's wrapper against its plain torch version
     on the card, at the shapes of the main path, with times (CUDA events,
     median of several runs), each beside its bound (the larger of the
     bytes it must move at 3.35 TB/s and its operations at 67 TFLOP/s fp32)
     and, where one PyTorch call computes the same function, that call's
     time (`library_ms`; the port never calls it):
       K1 Schroeder EDC: 64 rows x 2^20 with mixed lengths, 16 rows x
          (2^20 - 3*4096) (no multiple of 16384) and the main path's 16 and
          48 rows x 2^20; within 0.02 dB above -100 dB, exactly 0 past
          `length`, 0 dB at index 0, two calls bit-identical, and no spills
          in ptxas' report; timed at 16 and 48 rows x 2^20, a single call
          with its wrapper and a call within 20 back to back (no single
          PyTorch call; torch.cumsum of the squared plane, the scan core
          alone, is logged beside it); and at the --bands-decimate planes
          (16, 2^15), (16, 2^18) and (12, 2^14), checked and timed the same;
       K2 STFT magnitude: 16 rows x 2^20 at (4096, 512) and at (8192, 512)
          with the modal k_out; max |err| / max(ref) < 1e-5; library call
          torch.stft(center=False, Hann) + abs;
       K5 decay fits: the engine's T30, T20 and EDT ranges on K1's curves
          of decaying noise with drawn lengths at the main path's shapes
          of a 24 s tap (1,155,072 samples): a chunk's 16 broadband rows
          and 48 three-band rows, and a tap's 52 third-octave rows; kernel
          and plain version on the same card tensors, held together by
          tests/_dbfit_compare.py (crossing times, point counts and `ok`
          bit-equal, sums within its TOLERANCE and within one float32
          rounding of a float64 fit over the same window), plus its edge
          rows; two calls bit-identical; bound: the bytes these curves
          need (each row read up to its last crossing, then its windows'
          union), beside two reads of the plane (`two_reads_ms`);
     (K3 and K4 run on the gen CLI's and the reports' paths, and are held
     to their plain versions in phases 9 and 10; K5 runs once after each
     of the engine's K1 launches, and its launches are counted beside
     K1's on every path; ptxas' report must
     list every instance of K1, K3, K4 and K5 (PTXAS_KERNELS) and show no
     spill in any kernel);
  3. write a deterministic 16-tap stereo bundle of 2^20 samples per tap
     (bench.py's recipe) under build/;
  4. drive `bundle --no-plots` of the port through its CLI entry, 8 taps
     per chunk, with the kernels' launch counters set to 0 just before and
     read just after (each must be > 0): the process's first bundle of two
     chunks eager (no capture: one call of the key ahead, below
     graphs.MIN_CALLS_AHEAD); the second run, the key having ended a call,
     captures its step into a CUDA graph (engine/graphs.py) after its first
     chunk and replays it for the second (1 capture, 1 replay, the
     capture's host ms, the same launches); then warm runs in turns:
     through the graphs (both chunks replayed; the first run after eager()
     captures again and is kept apart as `recapture`), under
     `engine.eager()`, and with the plain versions swapped in (always
     under eager(): a graph captured with the kernels would replay them);
  5. check the run: every tap's markdown and bundle_metrics.json exist,
     metrics are finite where their *_ok flag is set, and the same run with
     the plain torch versions swapped in on the card agrees (markdown line
     by line, numbers within 2 units of the printed precision + 2e-3
     relative; JSON integers and flags exact, floats within 1e-4, per-bin
     modal fits 1e-2, group delay 1e-3 relative); the graph run is
     bit-equal to the eager() kernel run (every markdown byte, every
     bundle_metrics.json value but the timings);
  6. where one chunk's device time goes (profiler device-busy time of the
     eager step, each block toggled off in turn, and the bands block with
     --bands-decimate; then the chunk's graph: capture ms, one replay's
     CUDA-event elapsed and device-busy ms), and the bundle under other
     loads: octave and third-octave bands (a graph each: none cold, 1
     capture and 5 replays in 3 warm runs, and a profiled warm octave
     run), every chunk decoded and uploaded again, the graphs' memory pool
     with three keys live, and a warm run under torch.profiler through the
     graphs and under eager(): the device's busy share and events, the
     host's launch calls (cudaGraphLaunch, cudaLaunchKernel, copies) and
     the device events inside graph launches, which must hold exactly the
     K1 and K2 launches the counters add in that run; the cold bundle in
     fresh processes as the policy runs it, under eager() and captured
     after its first chunk (each twice; the captured run bit-equal to the
     eager() run); and the capture's break-even on a 64-tap bundle (8
     chunks: eager, captured after the first chunk, all replayed);
  7. the rest of the engine fast path through the CLI entry, each command
     with the launch counters set to 0 before it and read after it:
     `bundle --no-plots --bands-decimate` (8 K1 launches for 2 chunks, the
     kernel run against the plain run, its band fits against the full-rate
     run logged, a profiled warm run whose device events inside graph
     launches hold exactly its 8 and 4 counted launches), third-octave
     with decimation, `--compare <own reports> --fail-on-change` on an
     unchanged rerun (exit 0, no change flagged) and the `compare`
     subcommand, `batch --no-plots` over 4 tap WAVs (agrees with the
     bundle run), and `watch --max-bundles 2` over two copies of a 4-tap
     bundle with one tap re-recorded (two indexes, the second flagging a
     change, two event-log lines); batch runs three times (eager, then
     captured after its one chunk, then a replay), and both watched
     bundles replay the batch's graph;
  8. the per-file subcommands through the CLI entry on the card
     (`<cmd> --input X.wav --no_show --json out.json`): decay (also
     --smoothing 480), rt60bands (three, octave, third), fr, groupdelay,
     spectrogram (also --n_fft 3000), diffusion, waterfall, modalcloud
     (also --n_fft 32768) on a 2^20-sample stereo tap of the bundle, the
     eight analyses again on examples/gallery/verb_ir.wav, and deconvolve
     of a 2^20-sample log sweep played through the tap. Each runs cold,
     warm, and with the plain versions swapped in; the kernel run and the
     plain run agree (summaries within the per-module tolerances of
     tests/test_reference_parity.py, the same JSON keys, the same IR WAV),
     and the launches of K1 and K2 in one run are exactly as expected
     (decay and rt60bands K1 once, spectrogram, waterfall and modalcloud K2
     once, K2 never at n_fft 3000 or 32768). The eight analyses of the
     golden IR (tests/golden_utils.py) on the card agree with the reference
     tool's vendored summaries (tests/golden/reference/*.txt). The per-file
     shapes of K1 ((2, 2^20) and three bands x stereo (6, 2^20)) and of K2
     ((2, 2^20) at (4096, 512) and (8192, 512), every bin) are checked and
     timed in phase 2 under the kernels line's `shapes` with
     "path": "per_file".
  9. the rest of the per-file commands and the gen CLI through their CLI
     entries on the card, none of which launches K1, K2 or K4 (checked: 0
     in every run; K3 once in each gen run, 0 elsewhere): filter, filter / fr / groupdelay --exact-grid (host
     float64), zplane at its default order 256 and with --zeros --ridge
     1e-5, and ir --json, on the tap and on verb_ir.wav, each cold, warm
     (under torch.profiler on the tap) and with --device cpu (zplane's CPU
     runs on verb_ir.wav only); the card run against the CPU run
     (summaries within the per-module tolerances, EXACT_TOLERANCES for the
     exact grid, zplane's pole counts exact and radii within 8e-2, an
     unstable-count flip logged; the same JSON keys). The AR Gram of the
     tap's order-256 fit alone: CUDA-event time against its float32 bound,
     peak memory, and its relative Frobenius error against a float64 Gram
     on the card (<= 1e-5). `gen --channel_mode stereo all` and
     `karplus_pluck --freq 110` / `--freq 4000` on the card against
     `--device cpu` (WAV files byte-identical), with the Karplus-Strong
     device time and events under torch.profiler. K3 (csrc/karplus.cu)
     against its plain version on the card, bit for bit: at the gen CLI's
     calls (one string, 2 s, L = 12 and 436) and at L 1, 2, 12, 31, 32, 33,
     64, 436 and 2400 with 1 and 8 strings and 2 s + 1 sample; CUDA-event
     times of both, the bound and the chain floor (periods x 5 dependent
     fp32 operations of 4 cycles at the SM clock nvidia-smi reads while
     the kernels run) (`per_file_rest.karplus_kernel`).
 10. the plot reports (outputs under build/chip_smoke_plots/): the tap's
     report in process with its render jobs recorded, not drawn (K1 and
     K2 launched 2 and 2, exactly; the tap decoded once cold, the WAV read
     cache emptied first, and not at all in 3 warm reports, counted by
     wrapping the native decoder and scipy), cold, warm, under torch.profiler and
     with the plain versions swapped in, every render job's arrays within
     tests/_render_jobs.py's per-module tolerances of the plain run's and
     the markdown agreeing; the golden IR's report against
     tests/golden/verb_report_golden.md (golden_utils.compare_reports);
     the spectrogram's display pooling alone on the report's plane (time,
     bound, peak memory, profile, the image equal to the CPU's; the call's
     host-clock wall beside its wrapper's, the rest being the int16 copy
     and the host's work), and K4 (csrc/pool.cu) against its plain version
     on the card, int16 for int16: the report's call (column pooling 2),
     column pooling 1 and 3 with the channels' valid counts apart, a
     channel with no valid frame, and the report's plane with a floor that
     holds 60% of a channel's cells, with +-0 at the 99.5th percentile,
     and with NaN and +-inf cells; times of the wrapper, of its C entry
     alone (a memset and three launches, counted as device events under
     torch.profiler), of the plain version, and of torch.nanquantile per
     channel for the two percentiles alone (`library_ms`); K4 launched
     at least once a report on every report path, K3 never; the plot
     bundle runner over a 4-tap view with its jobs recorded (8 and 8).
     Where matplotlib imports: `report` through the CLI entry (cold, warm,
     plain, profiled; 15 PNGs, the ones the markdown embeds), the plot
     `bundle` with the render thread and with `--plot-processes 2` (8 and
     8 launches, each tap's PNGs, plot_timings.json), `--resume` (every
     tap cached, 0 launches) and `watch --plots` (10 and 10). Where it does
     not: `report`, the plot `bundle` and `watch --plots` must exit naming
     matplotlib before any work.
 11. the scale-out engine (rank files under build/chip_smoke_multi_device/):
     (a) `analyze_bundle_pipelined` over the bundle on a mesh of two shards
     on one card (`make_mesh(devices=[cuda:0, cuda:0])`, 8 taps a shard:
     one chunk, K1 and K2 launched 4 and 4, exactly; each shard a replay
     of the single-device chunk's graph), cold, warm beside the
     single-device run, under eager() (bit-equal) and with the plain
     versions swapped in; the mesh run against the single-device run (the
     largest difference per key reported) and against the plain run,
     under the JSON limits of phase 5; (b) a two-rank `bundle --multi-host` job through the CLI entry
     (`--coordinator 127.0.0.1:<free> --num-processes 2 --process-id i`),
     both ranks on cuda:0, 8 taps a rank, each rank running it cold and
     then warm twice in one process (K1 and K2 2 and 2 a run, exactly; the
     cold run eager, its one chunk having no call ahead, the first warm
     run capturing the rank's chunk, the second replaying it; engine
     seconds, peak memory, bytes sent through the gathers; no jax and nothing of the JAX
     package loaded), every rank with a timeout; only rank 0 prints the
     index line; the per-tap markdown bodies and bundle_metrics.json
     against the single-process run of phase 4, the index aggregates
     against numpy's median and mean of its per-tap values; the job's wall
     beside a single-process `bundle --no-plots` job's.

 12. the settings fuzz (`fuzz` line, outputs under build/chip_smoke_fuzz/),
     from one numpy Generator seeded by --fuzz-seed (default FUZZ_SEED; the
     seed is printed first, and each draw before it runs): K1 at 24 drawn
     shapes (rows 1-64, N from 1 to 2^20, Ns off the kernel's tile, lengths
     with 0, 1 and N among them, drawn eps and a floor that may be -inf)
     against its plain version under phase 2's rules and, on one or two
     rows a draw, against the port's float64 oracle (oracle.schroeder_edc_db)
     within 0.02 dB wherever the oracle is at or above -80 dB; K2 at every
     instance n_fft 256..16384 and five more drawn ones (drawn hops that do
     and do not divide n_fft, k_out, floor, window, ragged lengths, one draw
     with no frame) against its plain version and, on one row, against the
     oracle's magnitude (oracle.stft_magnitude_db), each within 1e-5 of the
     reference's largest value, and no K2 launch at n_fft 128, 3000 and
     20000; the fixed draw of each fuzz finding and five drawn EngineConfigs
     through `analyze_bundle_pipelined` on the bundle's first 8 taps, the
     kernel run against the plain run under phase 5's limits with
     tests/_engine_parity.py's conditioning runs, K1 / K2 launches exactly
     as the config implies (captured, then replayed with the same
     launches, the replay bit-equal to the eager() run), and a frame block longer than the signal
     raising a ValueError before any launch; ten drawn flag sets of decay,
     rt60bands, spectrogram, waterfall and modalcloud through the CLI entry
     on the bundle's first tap, the kernel run against the plain run
     (phase 8's tolerances, the same JSON keys), launches exact; ten drawn
     filter, zplane, deconvolve and ir runs and four drawn gen runs
     (Karplus-Strong first) on the card against --device cpu, neither
     kernel launched (phase 9's rules: filter's summaries within its
     tolerances, zplane's pole and zero counts exact and radii within
     8e-2, the deconvolved IR within tests/_fuzz_spaces.py's limits of the
     CPU run's peak, ir's JSON and stdout equal, gen's WAVs byte-identical,
     K3 launched once in a Karplus-Strong draw; the worst ratio per
     command); two
     meshes on cuda:0, of 1 and of 2 shards, each over 1-8 of the bundle's
     taps with a drawn EngineConfig and chunk, bit-equal to the
     single-device run with the same taps a chunk, K1 / K2 launched as
     expected_engine_launches says per shard. A failing draw raises;
     `python3 chip_smoke.py --fuzz-only --fuzz-seed S` reruns phases 1, 3
     and 12 alone with the printed seed.

The kernels line lists K1-K4, each with its launches on its own path
(`bundle` for K1 and K2, `gen karplus_pluck --freq 4000` for K3, the
recorded report for K4) and on every driven path (`launches_by_path`);
every path runs with all four counters set to 0 before it, and an engine
path fails if K1 or K2 never launched or K3 or K4 did. A K4 call is one
count of its wrapper and 4 device events (a memset, 3 launches; the
`device_events_per_call` of its shapes), a K3 call one count and one
launch.

Phases 1-9 must not load matplotlib; no phase may load jax or the JAX
package (audio_analysis_tpu). The last lines are the per-file JSON, the
phase-9 (`per_file_rest`) JSON, the phase-10 (`plots`) JSON, the phase-11
(`multi_device`) JSON, the phase-12 (`fuzz`) JSON, the kernels' JSON, the
card's name and power limit, and {"ok": true, "device": {...}}.
There is no CPU fallback: without CUDA the script exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent
SR = 48_000
TAPS = 16
N = 1 << 20
CHUNK_TAPS = 8
MAIN_PATH = "bundle"
# the paths K3 and K4 run on, whose launches the kernels line reports
KARPLUS_PATH = "gen karplus_pluck --freq 4000"
POOL_PATH = "report (figures recorded)"
# every kernel's launch counter name: K1, K2, K3, K4, K5
KERNELS = ("edc", "stft", "karplus", "pool", "dbfit")
# K1's planes under --bands-decimate at N = 2^20: (16, N/32) and (16, N/4)
# per three-band chunk of 8 stereo taps, (12, N/64) per third-octave tap
DECIMATED_EDC_SHAPES = ((16, N // 32), (16, N // 4), (12, N // 64))
# K1's planes of the per-file commands on a stereo 2^20 tap: decay, and
# rt60bands' three bands x stereo
PER_FILE_EDC_SHAPES = ((2, N), (6, N))
# per-module (rel, abs) summary tolerances of tests/test_reference_parity.py
SUMMARY_TOLERANCES = {
    "decay": (1e-3, 1e-3), "rt60bands": (1e-3, 2e-3), "fr": (5e-3, 1.0), "spectrogram": (1e-3, 0.5),
    "waterfall": (1e-3, 0.5), "modalcloud": (1e-2, 2e-3), "diffusion": (2e-2, 0.02), "groupdelay": (2e-2, 5.0),
}
# the fixture file of each per-file command under tests/golden/reference/
FIXTURES = {"fr": "frequency_response", "groupdelay": "group_delay"}
# phase 9: the card run against the --device cpu run; the exact grid is
# host float64 on both sides (tests/test_reference_parity.py
# EXACT_TOLERANCES), the z-plane radii within tests/parity_matrix.py's
# order-32 tolerance
REST_TOLERANCES = {"filter": (5e-3, 1.0), "exact_filter": (1e-6, 0.051), "exact_fr": (1e-6, 0.051),
                   "exact_groupdelay": (1e-6, 0.0051), "zplane": (8e-2, 5e-3)}
AR_ORDER = 256
GRAM_MAX_REL_ERR = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
FP32_FLOP_PER_S = 67e12  # fp32 outside the tensor cores, the same sheet


def bound(nbytes: float, flops: float) -> tuple:
    """(least ms the card could take, "bytes" or "operations")."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def kernel_name(mangled: str) -> str:
    """`name<args>` of a kernel from its mangled name: the identifier that
    ends in `_kernel` (found by the Itanium length prefixes) and its
    integer and bool template arguments; the mangled name where none."""
    # a run of digits may end in the length (hex digits of the namespace's
    # hash run into it), so each of the run's suffixes is tried
    for m in re.finditer(r"(?=(\d+))", mangled):
        start, n = m.start() + len(m.group(1)), int(m.group(1))
        ident = mangled[start:start + n]
        if ident.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*", ident):
            args = re.match(r"I((?:L[a-z]\d+E)+)E", mangled[start + n:])
            if not args:
                return ident
            values = []
            for kind, value in re.findall(r"L([a-z])(\d+)E", args.group(1)):
                values.append(("false", "true")[int(value)] if kind == "b" else value)
            return f"{ident}<{','.join(values)}>"
    return mangled


def ptxas_report(build_log: str) -> dict:
    """Registers, spill bytes and static shared memory of every kernel
    instance, from the `-Xptxas -v` lines of the build log."""
    report, name = {}, None
    for line in build_log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = kernel_name(entry.group(1))
            report[name] = {}
        elif name and "spill stores" in line:
            stores, loads = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            report[name].update(spill_store_bytes=int(stores), spill_load_bytes=int(loads))
        elif name and "registers" in line:
            report[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            report[name]["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return report


# the kernel instances of K1, K3, K4 and K5 that ptxas must report
PTXAS_KERNELS = ("edc_kernel", "dbfit_cross_kernel", "dbfit_sum_kernel", "karplus_thread_kernel<1>", "karplus_thread_kernel<2>", "karplus_thread_kernel<3>",
                 "karplus_warp_kernel<3>", "karplus_lanes_kernel<2,false>", "karplus_lanes_kernel<4,false>",
                 "karplus_lanes_kernel<2,true>", "karplus_lanes_kernel<4,true>", "karplus_lanes_kernel<8,true>",
                 "karplus_ring_kernel",
                 "pool_pass1_kernel", "pool_refine_kernel")


def time_ms(fn, reps: int = 7) -> float:
    """Median device time of one call, CUDA events around each call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_back_to_back_ms(fn, calls: int = 20, reps: int = 3) -> float:
    """Median device time of one call within a run of `calls` calls
    enqueued back to back (CUDA events around the run): the host's time to
    enqueue each call hides behind the device's work on the one before."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


# ------------------------------------------------------------ kernels ----


def edc_error(torch, edc, x, lengths) -> float:
    """K1 against its plain version on (x, lengths): max dB error above
    -100 dB; raises unless it is within 0.02 dB, the curve is exactly 0 past
    `length` and exactly 0 dB at index 0, and a second call is bit-identical
    to the first."""
    rows, n = x.shape
    got = edc.schroeder_edc_db_cuda(x, lengths)
    again = edc.schroeder_edc_db_cuda(x, lengths)
    ref = edc.schroeder_edc_db_plain(x, lengths)
    torch.cuda.synchronize()
    past = torch.arange(n, device=x.device)[None, :] >= lengths[:, None]
    usable = (ref > -100.0) & ~past
    err = (got - ref).abs()[usable].max().item()
    if not (err <= 0.02 and bool((got[past] == 0).all()) and bool((got[:, 0] == 0).all())):
        raise AssertionError(f"EDC kernel disagrees at ({rows}, {n}): {err} dB")
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"EDC kernel: two calls at ({rows}, {n}) differ")
    log(f"K1 edc ({rows}, {n}): max err {err:.3g} dB above -100 dB; 0 past length; "
        "0 dB at index 0; two calls bit-identical")
    return err


def check_edc(torch, edc, dev, g):
    """K1 against its plain version; returns (max dB error, per-shape
    timings)."""
    worst = 0.0
    for rows, n in ((64, N), (16, N - 3 * 4096)):
        t = torch.arange(n, dtype=torch.float32)
        tau = 2000.0 + 60000.0 * torch.rand(rows, 1, generator=g)
        x = torch.randn(rows, n, generator=g) * torch.exp(-t / tau)
        lengths = torch.randint(1, n + 1, (rows,), generator=g, dtype=torch.int32)
        lengths[0] = n
        x = torch.where(torch.arange(n) < lengths[:, None], x, 0.0).to(dev)
        worst = max(worst, edc_error(torch, edc, x, lengths.to(dev)))
    # the main path's calls per chunk of 8 stereo taps: 16 broadband rows
    # and 48 three-band rows. Bound: the rows read once, the dB plane
    # written once; about 4 operations a sample (square, add, log, scale).
    # torch.cumsum over the squared plane is the library's time for the
    # scan core alone; no single call computes the EDC (library_ms null).
    shapes = []
    for rows in (16, 48):
        t = torch.arange(N, dtype=torch.float32)
        xr = (0.01 * torch.randn(rows, N, generator=g) * torch.exp(-t / 30000.0)).to(dev)
        lr = torch.full((rows,), N, dtype=torch.int32, device=dev)
        worst = max(worst, edc_error(torch, edc, xr, lr))
        k = time_ms(lambda: edc.schroeder_edc_db_cuda(xr, lr))
        k_run = time_back_to_back_ms(lambda: edc.schroeder_edc_db_cuda(xr, lr))
        p = time_ms(lambda: edc.schroeder_edc_db_plain(xr, lr))
        energy = xr * xr
        scan = time_ms(lambda: torch.cumsum(energy, dim=-1))
        b, by = bound(rows * N * 4 * 2 + rows * 4, rows * N * 4.0)
        shapes.append({"shape": [rows, N], "ms": k, "plain_ms": p, "bound_ms": b, "bound_by": by,
                       "library_ms": None, "cumsum_ms": scan, "ms_back_to_back": k_run})
        log(f"K1 edc ({rows}, {N}): torch.cumsum of the squared plane (scan core only) {scan:.3f} ms")
        log(f"K1 edc ({rows}, {N}): kernel {k:.3f} ms ({k_run:.3f} ms a call back to back), "
            f"plain {p:.3f} ms, bound {b:.3f} ms ({by}), {b / k:.0%} of bound")
    # the decimated band planes of `--bands-decimate` (factors 32, 4 and 1
    # at 2^20): a three-band chunk's Low and Mid groups, and third-octave's
    # smallest group of one tap (6 bands at k = 64); and the per-file
    # commands' planes of one stereo tap. Same checks and bound.
    other = [(r, n, "bands_decimate") for r, n in DECIMATED_EDC_SHAPES]
    other += [(r, n, "per_file") for r, n in PER_FILE_EDC_SHAPES]
    for rows, n, path in other:
        t = torch.arange(n, dtype=torch.float32)
        xr = (0.01 * torch.randn(rows, n, generator=g) * torch.exp(-t / (30000.0 * n / N))).to(dev)
        lr = torch.randint(n // 2, n + 1, (rows,), generator=g, dtype=torch.int32)
        lr[0] = n
        xr = torch.where(torch.arange(n, device=dev) < lr.to(dev)[:, None], xr, 0.0)
        lr = lr.to(dev)
        worst = max(worst, edc_error(torch, edc, xr, lr))
        k = time_ms(lambda: edc.schroeder_edc_db_cuda(xr, lr))
        k_run = time_back_to_back_ms(lambda: edc.schroeder_edc_db_cuda(xr, lr))
        p = time_ms(lambda: edc.schroeder_edc_db_plain(xr, lr))
        b, by = bound(rows * n * 4 * 2 + rows * 4, rows * n * 4.0)
        shapes.append({"shape": [rows, n], "path": path, "ms": k, "plain_ms": p, "bound_ms": b,
                       "bound_by": by, "library_ms": None, "ms_back_to_back": k_run})
        log(f"K1 edc ({rows}, {n}) [{path}]: kernel {k:.3f} ms ({k_run:.3f} ms a call back to "
            f"back), plain {p:.3f} ms, bound {b:.4f} ms ({by}), {b / k:.0%} of bound")
    return worst, shapes


def check_stft(torch, stft, dev, g, k_out):
    """K2 against its plain version; returns (max abs err, per-shape
    timings). The main path's calls are one 8-tap chunk's (16 rows); the
    per-file commands' are one stereo tap's (2 rows) with every bin."""
    worst = 0.0
    shapes = []
    x16 = torch.randn(16, N, generator=g).to(dev)
    floor_lin = 10.0 ** (-120.0 / 20.0)
    calls = ((16, 4096, 512, None, None), (16, 8192, 512, k_out, None),
             (2, 4096, 512, None, "per_file"), (2, 8192, 512, None, "per_file"))
    for rows, n_fft, hop, kk, path in calls:
        x = x16[:rows]
        lengths = torch.full((rows,), N, dtype=torch.int32, device=dev)
        lengths[min(3, rows - 1)] = 500_000
        got = stft.stft_magnitude_cuda(x, lengths, n_fft, hop, True, floor_lin, kk)
        ref = stft.stft_magnitude_plain(x, lengths, n_fft, hop, True, floor_lin, kk)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        if not (got.shape == ref.shape and rel < 1e-5):
            raise AssertionError(f"STFT kernel disagrees at ({n_fft}, {hop}): rel {rel}")
        worst = max(worst, err)
        window = stft._window(n_fft, True, x.device)
        k = time_ms(lambda: stft.stft_magnitude_cuda(x, lengths, n_fft, hop, True, floor_lin, kk))
        p = time_ms(lambda: stft.stft_magnitude_plain(x, lengths, n_fft, hop, True, floor_lin, kk))
        lib = time_ms(
            lambda: torch.stft(x, n_fft, hop, window=window, center=False, return_complex=True).abs()
        )
        # bytes: signal, lengths, window and twiddle table read once, the
        # magnitude plane written once; operations: 2.5 n_fft log2 n_fft a
        # frame, the usual count of a real FFT
        rows, frames, bins = got.shape
        nbytes = x.numel() * 4 + rows * 4 + n_fft * 4 + (n_fft // 2 + 1) * 8 + got.numel() * 4
        b, by = bound(nbytes, rows * frames * 2.5 * n_fft * math.log2(n_fft))
        shape = {"shape": [rows, N, n_fft, hop, bins], "ms": k, "plain_ms": p, "bound_ms": b,
                 "bound_by": by, "library_ms": lib}
        shapes.append(shape if path is None else {**shape, "path": path})
        log(
            f"K2 stft ({rows}, {N}) n_fft={n_fft} hop={hop} k_out={kk}: shape {tuple(got.shape)} "
            f"max err {err:.3g} (rel {rel:.3g}); kernel {k:.3f} ms, plain {p:.3f} ms, "
            f"torch.stft+abs {lib:.3f} ms ({lib / k:.2f}x the kernel's speed), "
            f"bound {b:.3f} ms ({by}), {b / k:.0%} of bound"
        )
    return worst, shapes


# K5's calls on the main path's curves of a 24 s tap (1,152,000 samples
# padded to 1,155,072): (rows, path), the third-octave tap's path named
# since `bundle --no-plots` runs three bands
DBFIT_N = 1_155_072
DBFIT_SHAPES = ((16, None), (48, None), (52, "third_octave"))
DBFIT_RANGES = ((-5.0, -35.0), (-5.0, -25.0), (0.0, -10.0))  # EngineConfig's T30, T20, EDT


def dbfit_needed_samples(torch, curve, length, fits, levels, dt: float) -> tuple:
    """(prefix, union): the samples of the (rows, n) curves the fits cannot
    do without, each row read up to its last crossing (its length where a
    level is never reached), then the union of its windows once more."""
    from audio_analysis_tpu_torch.ops.common import bool_valid_mask

    n = curve.shape[-1]
    valid = bool_valid_mask(n, length)
    prefix = torch.zeros(curve.shape[:-1], dtype=torch.int64, device=curve.device)
    for level in levels:
        below = (curve <= level) & valid
        reach = torch.where(below.any(-1), torch.argmax(below.to(torch.uint8), -1) + 1, length.to(torch.int64))
        prefix = torch.maximum(prefix, reach)
    t = torch.arange(n, device=curve.device, dtype=torch.float32) * dt
    union = torch.zeros_like(valid)
    for fit in fits:
        union |= valid & (t >= fit.start_time_seconds[..., None]) & (t <= fit.end_time_seconds[..., None])
    return int(prefix.sum()), int(union.sum())


def check_dbfit(torch, edc, dbfit, dev, g):
    """K5 against its plain version on the same card tensors (K1's curves
    at the main path's shapes, and the edge rows); returns (largest
    kernel-plain gap of tests/_dbfit_compare.py's summed fields, relative
    as it measures them, and per-shape timings)."""
    sys.path.insert(0, str(REPO / "tests"))
    from _dbfit_compare import assert_edge_rows_cornered, assert_fits_agree, edge_curves

    dt = dbfit._seconds_per_sample(SR)
    levels = sorted({v for high, low in DBFIT_RANGES for v in (high, max(low, -80.0))})
    worst = 0.0
    shapes = []
    n = DBFIT_N
    for rows, path in DBFIT_SHAPES:
        # decaying noise falling 35-140 dB over the row, lengths drawn
        # (the first row whole), through K1
        tau = n / (8.0 + 52.0 * torch.rand(rows, 1, generator=g))
        x = torch.randn(rows, n, generator=g) * torch.exp(-torch.arange(n, dtype=torch.float32) / tau)
        lengths = torch.randint(n // 2, n + 1, (rows,), generator=g, dtype=torch.int32)
        lengths[0] = n
        x = torch.where(torch.arange(n) < lengths[:, None], x, 0.0).to(dev)
        lengths = lengths.to(dev)
        curve = edc.schroeder_edc_db_cuda(x, lengths)

        def kernel():
            return dbfit.fit_decay_ranges_cuda(curve, lengths, DBFIT_RANGES, -80.0, SR)

        got, again = kernel(), kernel()
        ref = dbfit.fit_decay_ranges_plain(curve, lengths, DBFIT_RANGES, -80.0, SR)
        torch.cuda.synchronize()
        for a, b in zip(got, again):
            for name in a._fields:
                if not torch.equal(getattr(a, name), getattr(b, name)):
                    raise AssertionError(f"K5 dbfit ({rows}, {n}): two calls differ in {name}")
        gaps = assert_fits_agree(got, ref, curve.cpu().numpy(), lengths.cpu().numpy(), dt)
        ok_share = float(ref[0].ok.float().mean())
        if ok_share <= 0.5:
            raise AssertionError(f"K5 dbfit ({rows}, {n}): only {ok_share:.0%} of the T30 fits ok")
        worst = max(worst, *gaps["kernel_vs_plain"].values())
        k = time_ms(kernel)
        k_run = time_back_to_back_ms(kernel)
        p = time_ms(lambda: dbfit.fit_decay_ranges_plain(curve, lengths, DBFIT_RANGES, -80.0, SR))
        prefix, union = dbfit_needed_samples(torch, curve, lengths, got, levels, dt)
        needed = 4 * (prefix + union)
        out_bytes = len(DBFIT_RANGES) * rows * (6 * 4 + 4 + 1) + rows * 4
        # operations: a compare a level a sample up to the last crossing;
        # each window sample's 2 differences, 3 products and 5 sums in
        # float64, at half the float32 rate (counted twice)
        in_windows = sum(int(f.num_points.sum()) for f in got)
        b, by = bound(needed + out_bytes, prefix * len(levels) + in_windows * 10 * 2)
        two_reads = 2 * rows * n * 4 / HBM_BYTES_PER_S * 1e3
        shape = {"shape": [rows, n], "ms": k, "plain_ms": p, "bound_ms": b, "bound_by": by,
                 "library_ms": None, "ms_back_to_back": k_run, "two_reads_ms": two_reads,
                 "needed_bytes": needed, "t30_ok_share": ok_share, **gaps}
        shapes.append(shape if path is None else {**shape, "path": path})
        log(f"K5 dbfit ({rows}, {n}){'' if path is None else f' [{path}]'}: crossings, counts and ok "
            f"bit-equal to the plain version, sums {gaps['kernel_vs_plain']}, two calls bit-identical; "
            f"kernel {k:.3f} ms ({k_run:.3f} ms a call back to back), plain {p:.3f} ms, bound {b:.3f} ms "
            f"({by}, {needed / 2**20:.1f} MiB needed), {b / k:.0%} of bound; two reads {two_reads:.3f} ms")
    curve, lengths = edge_curves(4096 + 3)
    curve, lengths = curve.to(dev), lengths.to(dev)
    got = dbfit.fit_decay_ranges_cuda(curve, lengths, DBFIT_RANGES, -80.0, SR)
    ref = dbfit.fit_decay_ranges_plain(curve, lengths, DBFIT_RANGES, -80.0, SR)
    assert_edge_rows_cornered(ref)
    assert_fits_agree(got, ref, curve.cpu().numpy(), lengths.cpu().numpy(), dt)
    log("K5 dbfit edge rows (length 0, < 8 points, no lower crossing, flat, crossings at index 0, on the "
        "targets to the bit, noise): agree with the plain version")
    return worst, shapes


def kernel_entry(name, source, replaces, launches_by_path, err, shapes, path=MAIN_PATH) -> dict:
    """One kernel of the kernels line: times, bounds and library times summed
    over its calls in one run of its own path (`path`: one chunk of the main
    path, `bundle --no-plots`, for K1 and K2; KARPLUS_PATH for K3, POOL_PATH
    for K4), with each call's numbers under `shapes` (calls of another path
    carry its name under "path" and stay out of the sums). `launches` is
    that path's count; `launches_by_path` holds every driven path's."""
    main = [sh for sh in shapes if "path" not in sh]
    libs = [sh["library_ms"] for sh in main]
    ms = sum(sh["ms"] for sh in main)
    bound_ms = sum(sh["bound_ms"] for sh in main)
    kinds = {sh["bound_by"] for sh in main}
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches_by_path[path], "path": path, "launches_by_path": launches_by_path,
        "max_abs_err": err,
        "ms": ms, "plain_ms": sum(sh["plain_ms"] for sh in main),
        "bound_ms": bound_ms, "bound_by": kinds.pop() if len(kinds) == 1 else "mixed",
        "bound_share": bound_ms / ms,
        "library_ms": None if None in libs else sum(libs),
        "shapes": shapes,
    }


# ------------------------------------------------------------- bundle ----


def write_bench_bundle(root: Path, write_bundle) -> Path:
    import numpy as np

    rng = np.random.default_rng(7)
    t = np.arange(N) / SR
    taps = {}
    for i in range(TAPS):
        rt60 = 0.9 + 0.7 * (i / max(1, TAPS - 1))
        env = (10.0 ** (-3.0 * t / rt60)).astype(np.float32)
        x = np.zeros((N, 2), np.float32)
        x[256:, :] = 0.05 * rng.standard_normal((N - 256, 2)).astype(np.float32) * env[: N - 256, None]
        x[256, :] = 0.9
        taps[f"tap{i:02d}"] = x
    return write_bundle(root, taps, SR)


_NUM = re.compile(r"-?\d+\.\d+|-?\d+")


def compare_markdown(a: str, b: str, where: str) -> None:
    la, lb = a.splitlines(), b.splitlines()
    if len(la) != len(lb):
        raise AssertionError(f"{where}: {len(la)} vs {len(lb)} lines")
    for x, y in zip(la, lb):
        if _NUM.sub("#", x) != _NUM.sub("#", y):
            raise AssertionError(f"{where}: {x!r} vs {y!r}")
        for s, t in zip(_NUM.findall(x), _NUM.findall(y)):
            if "." not in s:
                if s != t:
                    raise AssertionError(f"{where}: {x!r} vs {y!r}")
                continue
            tol = 2.0 * 10.0 ** (-len(s.split(".")[1])) + 2e-3 * abs(float(s))
            if abs(float(s) - float(t)) > tol:
                raise AssertionError(f"{where}: {x!r} vs {y!r}")


def compare_metrics(ours: dict, ref: dict) -> None:
    import numpy as np

    rtol = {"modal_rt60": 1e-2, "modal_r2": 1e-2, "gd_p10": 1e-3, "gd_median": 1e-3, "gd_p90": 1e-3}
    if list(ours) != list(ref):
        raise AssertionError("metric keys differ")
    for key in ref:
        a, b = np.asarray(ours[key]), np.asarray(ref[key])
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{key}: shape/dtype {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
        if a.dtype != np.float64:
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol.get(key, 1e-4), atol=1e-4, equal_nan=True, err_msg=key)


def check_finite(metrics: dict) -> None:
    """Every metric finite where its fit's *_ok flag is set (everywhere for
    metrics without one); modal_rt60 finite exactly on modal_count bins."""
    import numpy as np

    fits = ("band_t30", "band_t20", "band_edt", "early10", "edt", "t20", "t30")
    for key, value in metrics.items():
        if key.endswith("_ok") or key.startswith("modal_"):
            continue
        arr = np.asarray(value, dtype=np.float64)
        prefix = next((f for f in fits if key.startswith(f + "_")), None)
        mask = np.asarray(metrics[prefix + "_ok"], bool) if prefix else np.ones(arr.shape, bool)
        if not np.all(np.isfinite(arr[mask])):
            raise AssertionError(f"{key}: non-finite values where valid")
    rt60 = np.asarray(metrics["modal_rt60"], dtype=np.float64)
    if not np.array_equal(np.isfinite(rt60).sum(axis=-1), np.asarray(metrics["modal_count"])):
        raise AssertionError("modal_rt60 finite entries do not match modal_count")


def run_cli(main, root: Path, subdir: str, *extra: str) -> float:
    """Wall seconds of one `bundle --no-plots` run through the port's CLI."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    main(["bundle", "--input", str(root), "--no-plots", "--reports-subdir", subdir, *extra])
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def graph_runs(fn) -> tuple:
    """(fn(), the engine step's graph captures, replays and evictions in it)."""
    from audio_analysis_tpu_torch.engine import graphs

    before = graphs.STEP_GRAPHS.stats()
    result = fn()
    after = graphs.STEP_GRAPHS.stats()
    return result, {k: after[k] - before[k] for k in ("captures", "replays", "evictions")}


def check_bit_equal(root: Path, ours: str, ref: str, taps, where: str) -> None:
    """Two runs' reports identical: every tap's markdown byte for byte and
    bundle_metrics.json but its timings (taps, channels, aggregates, every
    metric, NaN included)."""
    a, b = (json.loads((root / d / "bundle_metrics.json").read_text()) for d in (ours, ref))
    differing = [k for k in b["metrics"] if json.dumps(a["metrics"].get(k)) != json.dumps(b["metrics"][k])]
    differing += [k for k in ("taps", "channels", "bundle_median_t30") if json.dumps(a[k]) != json.dumps(b[k])]
    differing += [t for t in taps if (root / ours / t / f"{t}_report.md").read_bytes()
                  != (root / ref / t / f"{t}_report.md").read_bytes()]
    if differing or list(a["metrics"]) != list(b["metrics"]):
        raise AssertionError(f"{where}: not bit-equal: {differing}")
    log(f"{where}: bit-equal ({len(taps)} taps' markdown, {len(b['metrics'])} metrics)")


def device_busy(torch, fn) -> dict:
    """One fn() under torch.profiler: its wall seconds, the device-busy ms
    (the union of the intervals in which the card ran a kernel or a copy),
    the number of device events and the three names with the most device
    time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_start, cur_end = 0.0, None, None
    for lo, hi in spans:
        if cur_end is None or lo > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = lo, hi
        else:
            cur_end = max(cur_end, hi)
    if cur_end is not None:
        busy += cur_end - cur_start
    by_name: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return {
        "wall_s": wall,
        "device_busy_ms": busy / 1e3,
        "busy_share": busy / 1e3 / (wall * 1e3),
        "device_events": len(events),
        "top_ms": [[name[:60], ms] for name, ms in top],
        **host_launches(prof),
    }


# host-side calls that put work on the device
HOST_LAUNCH_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


def host_launches(prof) -> dict:
    """From one torch.profiler trace: the host-side launch calls by name,
    the device events that ran inside graph launches (their correlation id
    is a cudaGraphLaunch's), K1's, K2's and each of K5's two passes among
    them, and every device event of kineto's raw results (device_busy
    counts those of prof.events(), which can hold fewer)."""
    calls = {name: 0 for name in HOST_LAUNCH_CALLS}
    graph_launches = set()
    events = list(prof.profiler.kineto_results.events())
    for e in events:
        if e.device_type().name == "CPU" and e.name() in calls:
            calls[e.name()] += 1
            if e.name() == "cudaGraphLaunch":
                graph_launches.add(e.correlation_id())
    in_graphs = {"all": 0, "edc": 0, "stft": 0, "dbfit": 0, "dbfit_cross": 0}
    device_events = 0
    for e in events:
        device_events += e.device_type().name == "CUDA"
        if e.device_type().name == "CUDA" and e.correlation_id() in graph_launches:
            in_graphs["all"] += 1
            for kernel, name in (("edc", "edc_kernel"), ("stft", "stft_mag_kernel"), ("dbfit", "dbfit_sum_kernel"),
                                 ("dbfit_cross", "dbfit_cross_kernel")):
                in_graphs[kernel] += name in e.name()
    return {"host_calls": calls, "device_events_in_graphs": in_graphs, "kineto_device_events": device_events}


def block_times(torch, analyze_batch, EngineConfig, root: Path, dev) -> dict:
    """Where one 8-tap chunk's device time goes. `chunk_elapsed_ms` is the
    stream's elapsed time (CUDA events) of the eager step, which also holds
    the device's idle gaps while the host enqueues the eager ops; the
    `*_busy_ms` entries are device-busy time from torch.profiler: all
    blocks on, and each block as the drop when it alone is toggled off
    (eager `analyze_batch`); then the step's graph: `capture_ms` and one
    replay's `chunk_replay_elapsed_ms` and `chunk_replay_busy_ms`."""
    import numpy as np

    from audio_analysis_tpu_torch.engine import graphs
    from audio_analysis_tpu_torch.engine.batch import analyze_batch_flat
    from audio_analysis_tpu_torch.io import open_bundle_chunks_i16

    _meta, lengths, _names, _n_max, loader = open_bundle_chunks_i16(root)
    pcm = torch.from_numpy(np.ascontiguousarray(loader(0, CHUNK_TAPS))).to(dev)
    lens = torch.from_numpy(lengths[:CHUNK_TAPS].copy()).to(dev)

    def busy_ms(cfg) -> float:
        analyze_batch(pcm, lens, cfg)  # warm: tables, cuFFT plans
        return device_busy(torch, lambda: analyze_batch(pcm, lens, cfg))["device_busy_ms"]

    base = EngineConfig()
    out = {"chunk_elapsed_ms": time_ms(lambda: analyze_batch(pcm, lens, base), reps=3)}
    full = out["chunk_busy_ms"] = busy_ms(base)
    # FR and group delay share one rfft, so they go off together
    off = {}
    for label, flags in (
        ("bands", ("run_bands",)),
        ("fr_group_delay", ("run_fr", "run_group_delay")),
        ("stft", ("run_stft",)),
        ("modal", ("run_modal",)),
        ("diffusion", ("run_diffusion",)),
    ):
        off[label] = busy_ms(replace(base, **{f: False for f in flags}))
        out[label + "_busy_ms"] = full - off[label]
    # the bands block with --bands-decimate, against the same bands-off run
    decimated = replace(base, bands_decimate=True)
    out["chunk_decimated_busy_ms"] = busy_ms(decimated)
    out["bands_decimated_busy_ms"] = out["chunk_decimated_busy_ms"] - off["bands"]
    out["chunk_decimated_elapsed_ms"] = time_ms(lambda: analyze_batch(pcm, lens, decimated), reps=3)
    out["align_decay_busy_ms"] = busy_ms(
        replace(
            base, run_bands=False, run_fr=False, run_group_delay=False, run_stft=False,
            run_modal=False, run_diffusion=False,
        )
    )
    # the chunk as the bundle runs it: its graph captured (host ms of the
    # capture and instantiation), then one replay's stream-elapsed time
    # (the static inputs' copies and the output's clone included) and
    # device-busy time
    graphs.STEP_GRAPHS.clear()
    analyze_batch_flat(pcm, lens, base, graphs.MIN_CALLS_AHEAD)
    (key,) = graphs.STEP_GRAPHS.keys()
    out["capture_ms"] = graphs.STEP_GRAPHS.capture_ms(key)
    out["chunk_replay_elapsed_ms"] = time_ms(lambda: analyze_batch_flat(pcm, lens, base), reps=5)
    out["chunk_replay_busy_ms"] = device_busy(torch, lambda: analyze_batch_flat(pcm, lens, base))["device_busy_ms"]
    return out


def graph_pool_gib(torch, dev) -> dict:
    """GiB the allocator holds on `dev` in the pool the live step graphs
    share (`live`) and in pools no graph uses any more, freed at the next
    empty_cache or allocation that runs short (`unused`)."""
    from audio_analysis_tpu_torch.engine import graphs

    pool = graphs.STEP_GRAPHS.pool(dev)
    out = {"live": 0.0, "unused": 0.0}
    for seg in torch.cuda.memory_snapshot():
        seg_pool = tuple(seg.get("segment_pool_id", (0, 0)))
        if seg["device"] == dev.index and seg_pool != (0, 0):
            out["live" if pool is not None and seg_pool == tuple(pool) else "unused"] += seg["total_size"] / 2**30
    return out


def profiled_launches(torch, counters, fn, where: str) -> dict:
    """fn() under torch.profiler with the launch counters read around it;
    every kernel launch the counters add must be a device event inside a
    graph launch (fn replays every chunk), K1's, K2's and K5's counted
    apart (a K5 launch is one event of each of its two passes)."""
    prof, launches = count_launches(counters, lambda: device_busy(torch, fn))
    in_graphs = prof["device_events_in_graphs"]
    counted = (launches["edc"], launches["stft"], launches["dbfit"], launches["dbfit"])
    if (in_graphs["edc"], in_graphs["stft"], in_graphs["dbfit"], in_graphs["dbfit_cross"]) != counted:
        raise AssertionError(f"{where}: counted launches {launches}, device events inside graph launches {in_graphs}")
    return {**prof, "launches": launches}


# One cold run in a fresh process (phase 6's cold split): `bundle
# --no-plots` of the 16-tap bundle through the CLI entry ("bundle16", 2
# chunks), or `analyze_bundle` of its taps four times over ("taps64", 8
# chunks); the step as the policy decides ("default"), under eager()
# ("eager"), or captured after its first chunk whatever the calls ahead
# ("capture"). Each step call's host ms and the capture's (`_add`, the
# static inputs and the pool included) split the run.
COLD_CODE = r"""
import contextlib, json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from audio_analysis_tpu_torch.cli.analyse_cli import main
from audio_analysis_tpu_torch.engine import EngineConfig, analyze_bundle, graphs, mesh
from audio_analysis_tpu_torch.io import open_bundle_chunks_i16

out_json, workload, mode, root, subdir = sys.argv[2:7]
torch.empty(0, device="cuda:0")  # the context, outside the wall
if mode == "capture":
    graphs.STEP_GRAPHS.min_calls_ahead = 0
steps_ms, adds_ms = [], []
real_step, real_add = mesh.analyze_batch_flat, graphs.StepGraphs._add

def timed_step(*args):
    t0 = time.perf_counter()
    result = real_step(*args)
    steps_ms.append((time.perf_counter() - t0) * 1e3)
    return result

def timed_add(self, *args):
    t0 = time.perf_counter()
    real_add(self, *args)
    adds_ms.append((time.perf_counter() - t0) * 1e3)

mesh.analyze_batch_flat, graphs.StepGraphs._add = timed_step, timed_add
if workload == "taps64":
    _meta, lengths, _names, _n, loader = open_bundle_chunks_i16(root)
    taps, lens = np.concatenate([loader(0, len(lengths))] * 4), np.concatenate([lengths] * 4)
    run = lambda: analyze_bundle(taps, lens, EngineConfig(), 8, device="cuda:0")
else:
    run = lambda: main(["bundle", "--input", root, "--no-plots", "--reports-subdir", subdir])
before = graphs.STEP_GRAPHS.stats()
torch.cuda.synchronize()
t0 = time.perf_counter()
with graphs.eager() if mode == "eager" else contextlib.nullcontext():
    run()
torch.cuda.synchronize()
wall = time.perf_counter() - t0
after = graphs.STEP_GRAPHS.stats()
keys = graphs.STEP_GRAPHS.keys()
json.dump({"wall_s": wall, "graphs": {k: after[k] - before[k] for k in ("captures", "replays")},
           "capture_ms": graphs.STEP_GRAPHS.capture_ms(keys[0]) if keys else None,
           "step_host_ms": steps_ms, "add_host_ms": adds_ms,
           "peak_device_memory_gib": torch.cuda.max_memory_allocated(0) / 2**30,
           "peak_device_memory_reserved_gib": torch.cuda.max_memory_reserved(0) / 2**30}, open(out_json, "w"))
"""


def cold_split(torch, root: Path) -> dict:
    """Cold runs in fresh processes, one after another on the card: the
    16-tap bundle through the CLI (2 chunks) and 64 taps through
    `analyze_bundle` (8 chunks), each as the capture policy runs it, under
    eager(), and captured after its first chunk; each mode twice, in the
    order default, eager, capture, capture, eager, default. Wall of the
    call (the CUDA context made before it), each step call's host ms, the
    capture's, and the bundle's `h2d_dispatch_s`; the captured bundle
    bit-equal to the eager() one."""
    import os

    work = REPO / "build" / "chip_smoke_cold"
    work.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = {}
    for workload, chunks in (("bundle16", TAPS // CHUNK_TAPS), ("taps64", 4 * TAPS // CHUNK_TAPS)):
        expected = {"default": (0, 0) if chunks - 1 < graphs_min_calls_ahead() else (1, chunks - 1),
                    "eager": (0, 0), "capture": (1, chunks - 1)}
        out[workload] = {mode: [] for mode in expected}
        for i, mode in enumerate(("default", "eager", "capture", "capture", "eager", "default")):
            result = work / f"{workload}_{i}.json"
            subdir = f"reports_cold_{mode}"
            run_processes([[sys.executable, "-c", COLD_CODE, str(REPO), str(result), workload, mode, str(root),
                            subdir]], env)
            one = json.loads(result.read_text())
            if (one["graphs"]["captures"], one["graphs"]["replays"]) != expected[mode]:
                raise AssertionError(f"cold {workload} {mode} run: graphs {one['graphs']}, expected {expected[mode]}")
            if workload == "bundle16":
                one["h2d_dispatch_s"] = json.loads((root / subdir / "bundle_metrics.json").read_text())[
                    "phases"].get("h2d_dispatch_s")
            out[workload][mode].append(one)
    names = json.loads((root / "reports_cold_eager" / "bundle_metrics.json").read_text())["taps"]
    check_bit_equal(root, "reports_cold_capture", "reports_cold_eager", names, "cold captured run vs cold eager() run")
    log("cold split (fresh processes): " + json.dumps(
        {w: {m: [round(r["wall_s"], 4) for r in v] for m, v in modes.items()} for w, modes in out.items()}))
    return out


def graphs_min_calls_ahead() -> int:
    from audio_analysis_tpu_torch.engine import graphs

    return graphs.MIN_CALLS_AHEAD


def capture_break_even(torch, root: Path, dev) -> dict:
    """The capture policy's threshold from this card: a bundle of 64 taps
    (the bundle's 16 four times over, 8 chunks of 8, the BASELINE bundle's
    size) through `analyze_bundle`, in 3 rounds of: under eager() (8 eager
    chunks), with the graph cleared (the first chunk eager, then the
    capture, 7 replays) and warm (8 replays). One replayed chunk saves
    `saving_ms` = (eager - warm) / 8; the capture costs `capture_cost_ms` =
    cleared - warm - saving_ms; it pays over `break_even_calls` =
    capture_cost_ms / saving_ms replays (graphs.MIN_CALLS_AHEAD)."""
    import numpy as np

    from audio_analysis_tpu_torch.engine import EngineConfig, analyze_bundle, graphs
    from audio_analysis_tpu_torch.io import open_bundle_chunks_i16

    _meta, lengths, _names, n_max, loader = open_bundle_chunks_i16(root)
    taps = np.concatenate([loader(0, TAPS)] * 4)
    lens = np.concatenate([lengths] * 4)
    chunks = len(taps) // CHUNK_TAPS

    def wall() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        analyze_bundle(taps, lens, EngineConfig(), CHUNK_TAPS, device=dev)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    out = {"taps": len(taps), "chunks": chunks, "eager_s": [], "capture_s": [], "warm_s": []}
    for _ in range(3):
        with graphs.eager():
            out["eager_s"].append(wall())
        graphs.STEP_GRAPHS.clear()
        t, ran = graph_runs(wall)
        if (ran["captures"], ran["replays"]) != (1, chunks - 1):
            raise AssertionError(f"break-even: graphs {ran} in a run with the graph cleared")
        out["capture_s"].append(t)
        t, ran = graph_runs(wall)
        if (ran["captures"], ran["replays"]) != (0, chunks):
            raise AssertionError(f"break-even: graphs {ran} in a warm run")
        out["warm_s"].append(t)
    eager_s, capture_s, warm_s = (statistics.median(out[k]) for k in ("eager_s", "capture_s", "warm_s"))
    out["saving_ms"] = (eager_s - warm_s) / chunks * 1e3
    out["capture_cost_ms"] = (capture_s - warm_s) * 1e3 - out["saving_ms"]
    out["break_even_calls"] = out["capture_cost_ms"] / out["saving_ms"] if out["saving_ms"] > 0 else None
    out["min_calls_ahead"] = graphs.MIN_CALLS_AHEAD
    log(f"capture break-even over {chunks} chunks: " + json.dumps(out))
    return out


def other_loads(torch, cli_main, root: Path, dev, counters) -> dict:
    """The same bundle under other loads: the octave and third-octave band
    modes (cold: eager; 3 warm, the first capturing the mode's graph:
    capture ms, peak memory; one more warm octave run under
    torch.profiler, its counted launches against the device events inside
    graph launches), every chunk decoded and uploaded again (3 runs), the
    graphs' memory with the three keys live, and one warm run under
    torch.profiler through the graphs (the same check) and one under
    eager(): the device's busy share, its events, the host's launch calls,
    and the device events inside graph launches."""
    from audio_analysis_tpu_torch.engine import graphs
    from audio_analysis_tpu_torch.report import EngineBundleSettings, run_bundle_report_engine

    out = {}
    for bands in ("octave", "third"):
        torch.cuda.reset_peak_memory_stats(dev)
        cold, ran = graph_runs(lambda: run_cli(cli_main, root, "reports_" + bands, "--bands", bands))
        warm, warm_ran = graph_runs(lambda: [run_cli(cli_main, root, "reports_" + bands, "--bands", bands)
                                             for _ in range(3)])
        if ran["captures"] or ran["replays"] or warm_ran["captures"] != 1 or warm_ran["replays"] != 5:
            raise AssertionError(f"--bands {bands}: graphs {ran} cold, {warm_ran} in 3 warm runs")
        key = next(k for k in graphs.STEP_GRAPHS.keys() if k[-1].band_mode == bands)
        out[bands] = {
            "cold_s": cold,
            "warm_s": warm,
            "capture_ms": graphs.STEP_GRAPHS.capture_ms(key),
            "peak_device_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "peak_device_memory_reserved_gib": torch.cuda.max_memory_reserved(dev) / 2**30,
        }
        if bands == "octave":
            out[bands]["warm_profiled"] = profiled_launches(
                torch, counters, lambda: run_cli(cli_main, root, "reports_octave", "--bands", "octave"), "octave")
    uncached = EngineBundleSettings(reports_subdir="reports_uncached", cache_device_audio=False)
    out["uncached_s"] = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_bundle_report_engine(root, uncached, dev)
        torch.cuda.synchronize()
        out["uncached_s"].append(time.perf_counter() - t0)
    out["graphs_live"] = len(graphs.STEP_GRAPHS.keys())
    out["graph_pools_gib"] = graph_pool_gib(torch, dev)
    out["device_memory_reserved_gib"] = torch.cuda.memory_reserved(dev) / 2**30
    out["memory_returns"] = graphs.STEP_GRAPHS.stats()["memory_returns"]
    run_cli(cli_main, root, "reports_cuda")
    out["warm_profiled"] = profiled_launches(torch, counters, lambda: run_cli(cli_main, root, "reports_cuda"),
                                             "warm run")
    with graphs.eager():
        run_cli(cli_main, root, "reports_eager")
        out["warm_profiled_eager"] = device_busy(torch, lambda: run_cli(cli_main, root, "reports_eager"))
    if out["warm_profiled"]["host_calls"]["cudaGraphLaunch"] < 2:
        raise AssertionError(f"warm run: fewer than 2 graph launches: {out['warm_profiled']}")
    out["cold_split"] = cold_split(torch, root)
    out["capture_break_even"] = capture_break_even(torch, root, dev)
    return out


def count_launches(counters, fn, path_kernels=("edc", "stft", "dbfit")):
    """fn() with every kernel's launch counter set to 0 just before and read
    just after; raises if a kernel of the path (`path_kernels`: the engine
    paths' K1, K2 and K5 by default) never launched, or another one did,
    or, on an engine path, K5 did not launch once after each K1 launch."""
    for counter in counters:
        counter.launches = 0
    result = fn()
    launches = {c.name: c.launches for c in counters}
    if not all(bool(n) == (name in path_kernels) for name, n in launches.items()):
        raise AssertionError(f"the path's kernels {path_kernels} never launched, or another did: {launches}")
    if "dbfit" in path_kernels and launches["dbfit"] != launches["edc"]:
        raise AssertionError(f"K5 launches {launches['dbfit']}, expected one a K1 launch: {launches}")
    return result, launches


@contextlib.contextmanager
def plain_versions():
    """The kernels' plain torch versions swapped in, with the engine step
    eager (`engine.eager()`, which clears the graph cache): a graph captured
    with the kernels would replay them under the swap."""
    from audio_analysis_tpu_torch.engine import eager
    from audio_analysis_tpu_torch.ops import dbfit, display, edc, stft
    from audio_analysis_tpu_torch.signals import torchgen

    with eager(), mock.patch.object(edc, "schroeder_edc_db_cuda", edc.schroeder_edc_db_plain), \
            mock.patch.object(stft, "stft_magnitude_cuda", stft.stft_magnitude_plain), \
            mock.patch.object(dbfit, "fit_decay_ranges_cuda", dbfit.fit_decay_ranges_plain), \
            mock.patch.object(torchgen, "karplus_strong_batch_cuda", torchgen.karplus_strong_batch_plain), \
            mock.patch.object(display, "_pooled_image_cuda", display._pooled_image_plain):
        yield


def cli_exit_code(main, argv) -> int:
    try:
        main(argv)
    except SystemExit as exc:
        return exc.code if isinstance(exc.code, int) else 1
    return 0


def band_fit_movement(full: dict, decimated: dict) -> dict:
    """Largest and median relative difference of each band fit between the
    full-rate and the decimated run where both fits are valid, with the
    (tap, channel, band) and both values of the largest."""
    import numpy as np

    out = {}
    for name in ("band_t30", "band_t20", "band_edt"):
        a, b = np.asarray(full[name + "_rt60"]), np.asarray(decimated[name + "_rt60"])
        ok = np.asarray(full[name + "_ok"], bool) & np.asarray(decimated[name + "_ok"], bool)
        if not ok.any():
            out[name] = None
            continue
        rel = np.where(ok, np.abs(b - a) / np.where(ok, np.abs(a), 1.0), -1.0)
        at = np.unravel_index(int(np.argmax(rel)), rel.shape)
        out[name] = {"max": float(rel[at]), "median": float(np.median(rel[ok])),
                     "at": [int(i) for i in at], "full_s": float(a[at]), "decimated_s": float(b[at])}
    return out


def fast_path_commands(torch, cli_main, root: Path, dev, counters, launches_by_path: dict, full_json: dict) -> dict:
    """Phase 7: the rest of the engine fast path through the CLI entry, each
    command with the launch counters read around it:
    `bundle --no-plots --bands-decimate` (cold, warm, against the plain
    versions, and against the full-rate run), third-octave with decimation,
    `--compare --fail-on-change` on an unchanged rerun and the `compare`
    subcommand, `batch --no-plots` over 4 of the bundle's taps, and `watch`
    over two copies of a 4-tap bundle, one tap re-recorded."""
    import contextlib
    import io
    import shutil

    from audio_analysis_tpu_torch.engine import EngineConfig
    from audio_analysis_tpu_torch.engine.batch import band_masks
    from audio_analysis_tpu_torch.io.wav import load_wav_file, write_wav_pcm16
    from audio_analysis_tpu_torch.ops import fftmask
    from audio_analysis_tpu_torch.report import count_flagged_in_text
    from audio_analysis_tpu_torch.report import watch as watch_module

    out = {}
    names = full_json["taps"]

    # 7.1 bundle --no-plots --bands-decimate: K1 once for the broadband
    # decay and once per band decimation group (3 at 2^20) a chunk
    torch.cuda.reset_peak_memory_stats(dev)
    cold, launches = count_launches(counters, lambda: run_cli(cli_main, root, "reports_decimate", "--bands-decimate"))
    launches_by_path["bundle --bands-decimate"] = launches
    groups = len(set(fftmask.band_decimation_factors(band_masks(EngineConfig(), N), N)))
    expected = -(-TAPS // CHUNK_TAPS) * (1 + groups)
    if launches["edc"] != expected:
        raise AssertionError(f"--bands-decimate: {launches['edc']} K1 launches, expected {expected}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    warm = [run_cli(cli_main, root, "reports_decimate", "--bands-decimate") for _ in range(3)]
    profiled = profiled_launches(torch, counters, lambda: run_cli(cli_main, root, "reports_decimate",
                                                                  "--bands-decimate"), "--bands-decimate")
    if profiled["launches"] != launches:
        raise AssertionError(f"--bands-decimate: launches {profiled['launches']} replayed, {launches} cold")
    with plain_versions():
        plain = run_cli(cli_main, root, "reports_decimate_plain", "--bands-decimate")
    dec_json = json.loads((root / "reports_decimate" / "bundle_metrics.json").read_text())
    plain_json = json.loads((root / "reports_decimate_plain" / "bundle_metrics.json").read_text())
    check_finite(dec_json["metrics"])
    compare_metrics(dec_json["metrics"], plain_json["metrics"])
    for tap in names:
        compare_markdown(
            (root / "reports_decimate" / tap / f"{tap}_report.md").read_text(),
            (root / "reports_decimate_plain" / tap / f"{tap}_report.md").read_text(),
            tap,
        )
    movement = band_fit_movement(full_json["metrics"], dec_json["metrics"])
    log(f"--bands-decimate: kernel run == plain run on the card; K1 launches {launches['edc']}; "
        f"largest relative band fit difference from the full-rate run {movement}")
    out["bands_decimate"] = {
        "cold_s": cold, "warm_s": warm, "plain_s": plain, "peak_device_memory_gib": peak,
        "warm_profiled": profiled,
        "band_fit_max_rel_diff_vs_full_rate": movement,
    }

    # 7.2 third-octave with --bands-decimate
    torch.cuda.reset_peak_memory_stats(dev)
    third = ("--bands", "third", "--bands-decimate")
    cold = run_cli(cli_main, root, "reports_third_decimate", *third)
    out["third_decimated"] = {
        "cold_s": cold,
        "warm_s": [run_cli(cli_main, root, "reports_third_decimate", *third) for _ in range(3)],
        "peak_device_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
    }

    # 7.3 the compare gate on an unchanged rerun, and the compare subcommand
    reports = root / "reports_cuda"
    t0 = time.perf_counter()
    code, launches = count_launches(counters, lambda: cli_exit_code(cli_main, [
        "bundle", "--input", str(root), "--no-plots", "--reports-subdir", "reports_cuda",
        "--compare", str(reports), "--fail-on-change",
    ]))
    rerun_s = time.perf_counter() - t0
    launches_by_path["bundle --compare --fail-on-change"] = launches
    if code != 0 or "No changes above threshold." not in (reports / "bundle_report.md").read_text():
        raise AssertionError(f"unchanged rerun: --fail-on-change exit {code}, or changes flagged")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        cli_main(["compare", str(reports), str(root / "reports_decimate")])
    flagged = count_flagged_in_text(text.getvalue())
    log(f"compare full-rate -> --bands-decimate: {flagged} flagged lines")
    out["compare"] = {"unchanged_rerun_s": rerun_s, "decimated_vs_full_rate_flagged": flagged}

    # 7.4 batch --no-plots over 4 of the bundle's tap WAVs
    picks = [names[i] for i in (0, 5, 10, 15)]
    batch_root = REPO / "build" / "chip_smoke_batch"
    shutil.rmtree(batch_root, ignore_errors=True)
    wavs = [str(root / "taps" / f"{tap}.wav") for tap in picks]
    batch_argv = ["batch", "--inputs", *wavs, "--output", str(batch_root), "--no-plots"]
    t0 = time.perf_counter()
    (_, launches), batch_graphs = graph_runs(lambda: count_launches(counters, lambda: cli_main(batch_argv)))
    launches_by_path["batch"] = launches
    batch_s = time.perf_counter() - t0
    batch_json = json.loads((batch_root / "reports" / "bundle_metrics.json").read_text())
    if batch_json["taps"] != picks:
        raise AssertionError(f"batch taps {batch_json['taps']}")
    rows = [names.index(tap) for tap in picks]
    compare_metrics(batch_json["metrics"], {k: [v[i] for i in rows] for k, v in full_json["metrics"].items()})
    # the same batch again: its one chunk (no call ahead) ran eagerly in
    # the first run; the key ended that call, so the second run captures
    # after it and the third replays
    t0 = time.perf_counter()
    _, capture_graphs = graph_runs(lambda: cli_main(batch_argv))
    capture_batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, warm_graphs = graph_runs(lambda: cli_main(batch_argv))
    warm_batch_s = time.perf_counter() - t0
    ran = [(g["captures"], g["replays"]) for g in (batch_graphs, capture_graphs, warm_graphs)]
    if ran != [(0, 0), (1, 0), (0, 1)]:
        raise AssertionError(f"batch: (captures, replays) {ran} in three runs, expected none, a capture, a replay")
    log(f"batch --no-plots over {len(picks)} tap WAVs agrees with the bundle run ({batch_s:.3f} s; "
        f"again {capture_batch_s:.3f} s, capturing; warm {warm_batch_s:.3f} s, a replay)")
    out["batch_s"] = batch_s
    out["batch_capture_s"] = capture_batch_s
    out["batch_warm_s"] = warm_batch_s
    out["batch_graphs"] = [batch_graphs, capture_graphs, warm_graphs]

    # 7.5 watch: two copies of a 4-tap bundle, one tap re-recorded at 0.9x
    watch_root = REPO / "build" / "chip_smoke_watch"
    shutil.rmtree(watch_root, ignore_errors=True)
    for run, scale in (("run1", 1.0), ("run2", 0.9)):
        taps_dir = watch_root / run / "taps"
        taps_dir.mkdir(parents=True)
        for tap in picks:
            shutil.copyfile(root / "taps" / f"{tap}.wav", taps_dir / f"{tap}.wav")
        if scale != 1.0:
            loaded = load_wav_file(taps_dir / f"{picks[0]}.wav")
            write_wav_pcm16(taps_dir / f"{picks[0]}.wav", loaded.samples * scale, SR)
        meta = {"sample_rate_hz": SR, "length_samples": N, "taps": picks}
        (watch_root / run / "meta.json").write_text(json.dumps(meta))  # last, as the recorder does
    real_watch = watch_module.watch_bundle_runs
    deadline = time.monotonic() + 180.0

    def bounded_watch(*args, **kwargs):
        return real_watch(*args, stop=lambda: time.monotonic() > deadline, **kwargs)

    t_start = time.time()
    with mock.patch.object(watch_module, "watch_bundle_runs", bounded_watch):
        (_, launches), watch_graphs = graph_runs(lambda: count_launches(counters, lambda: cli_main(
            ["watch", "--input", str(watch_root), "--max-bundles", "2", "--interval", "0.05"]
        )))
    launches_by_path["watch"] = launches
    # the batch run left the 4-tap key's graph: both bundles replay it
    if watch_graphs["replays"] != 2 or watch_graphs["captures"]:
        raise AssertionError(f"watch: graphs {watch_graphs}, expected a replay a bundle")
    events = [json.loads(line) for line in (watch_root / "watch_log.jsonl").read_text().splitlines()]
    indexes = [watch_root / run / "reports" / "bundle_report.md" for run in ("run1", "run2")]
    if len(events) != 2 or not all(p.is_file() for p in indexes):
        raise AssertionError(f"watch: {len(events)} events, indexes {[p.is_file() for p in indexes]}")
    second = indexes[1].read_text()
    if "## Changes vs" not in second or count_flagged_in_text(second) < 1:
        raise AssertionError("watch: the second index flags no change")
    cycles = [events[0]["ts"] - t_start, events[1]["ts"] - events[0]["ts"]]
    log(f"watch: 2 bundles, cycles {cycles[0]:.3f} s and {cycles[1]:.3f} s, "
        f"{count_flagged_in_text(second)} flagged lines in the second index")
    out["watch"] = {"cycle_s": cycles, "flagged_second": count_flagged_in_text(second), "graphs": watch_graphs,
                    "events": [{k: e.get(k) for k in ("compute_seconds", "audio_chunks_reused",
                                                      "audio_chunks_uploaded")} for e in events]}
    return out


def run_cli_text(torch, main, argv) -> tuple:
    """(wall seconds ending in a synchronize, stdout) of one CLI call."""
    import contextlib
    import io

    text = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        main(argv)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, text.getvalue()


def read_launches(counters, fn):
    """fn() with every kernel's launch counter set to 0 just before and read
    just after; the counts, whatever they are."""
    for counter in counters:
        counter.launches = 0
    result = fn()
    return result, {c.name: c.launches for c in counters}


def write_sweep_inputs(out: Path, tap: Path) -> tuple:
    """A 2^20-sample log sweep (20 Hz - 20 kHz, half-cosine fades) as a mono
    PCM16 WAV, and the sweep played through the stereo tap (float64 FFT
    convolution, full length, peak 0.5) as a stereo PCM16 WAV."""
    import numpy as np

    from audio_analysis_tpu_torch.io.wav import load_wav_file, write_wav_pcm16

    t = np.arange(N, dtype=np.float64) / SR
    k = math.log(20000.0 / 20.0)
    sweep = 0.5 * np.sin(2.0 * math.pi * 20.0 * (N / SR) / k * (np.exp(t / (N / SR) * k) - 1.0))
    ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(4096) / 4096)
    sweep[:4096] *= ramp
    sweep[-4096:] *= ramp[::-1]
    ir = load_wav_file(tap).samples.astype(np.float64)
    n_out = N + ir.shape[0] - 1
    n_fft = 1 << (n_out - 1).bit_length()
    rec = np.fft.irfft(np.fft.rfft(sweep, n_fft)[:, None] * np.fft.rfft(ir, n_fft, axis=0), n_fft, axis=0)[:n_out]
    rec *= 0.5 / np.abs(rec).max()
    write_wav_pcm16(out / "sweep.wav", sweep.astype(np.float32), SR)
    write_wav_pcm16(out / "recorded.wav", rec.astype(np.float32), SR)
    return out / "sweep.wav", out / "recorded.wav"


def per_file_commands(torch, cli_main, root: Path, dev, counters, launches_by_path: dict) -> dict:
    """Phase 8: the per-file subcommands through the CLI entry on the card,
    each cold, warm (once more under torch.profiler for the device-busy
    time, on the bundle tap) and with the plain versions swapped in; the
    kernel run against the plain run, K1 / K2 launches of one run against
    the expected counts, and the golden IR's summaries on the card against
    the reference tool's."""
    import shutil

    import numpy as np
    from scipy.io import wavfile

    from audio_analysis_tpu_torch.io.wav import write_wav_pcm16

    # the tests' golden IR and comparisons (numpy and re only)
    sys.path.insert(0, str(REPO / "tests"))
    import golden_utils
    from _summary_parity import assert_summaries_agree, json_skeleton

    out_dir = REPO / "build" / "chip_smoke_per_file"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    tap = root / "taps" / "tap00.wav"
    verb = REPO / "examples" / "gallery" / "verb_ir.wav"
    sweep, recorded = write_sweep_inputs(out_dir, tap)

    # (label, argv without --input / --json, input, expected (K1, K2) launches)
    runs = [
        ("decay", ["decay", "--no_show"], tap, (1, 0)),
        ("decay --smoothing 480", ["decay", "--no_show", "--smoothing", "480"], tap, (1, 0)),
        ("rt60bands", ["rt60bands", "--no_show"], tap, (1, 0)),
        ("rt60bands --band_mode octave", ["rt60bands", "--no_show", "--band_mode", "octave"], tap, (1, 0)),
        ("rt60bands --band_mode third", ["rt60bands", "--no_show", "--band_mode", "third"], tap, (1, 0)),
        ("fr", ["fr", "--no_show"], tap, (0, 0)),
        ("groupdelay", ["groupdelay", "--no-show"], tap, (0, 0)),
        ("spectrogram", ["spectrogram", "--no_show"], tap, (0, 1)),
        ("spectrogram --n_fft 3000", ["spectrogram", "--no_show", "--n_fft", "3000"], tap, (0, 0)),
        ("diffusion", ["diffusion", "--no_show"], tap, (0, 0)),
        ("waterfall", ["waterfall", "--no_show"], tap, (0, 1)),
        ("modalcloud", ["modalcloud", "--no_show"], tap, (0, 1)),
        ("modalcloud --n_fft 32768", ["modalcloud", "--no_show", "--n_fft", "32768"], tap, (0, 0)),
    ]
    runs += [(f"{argv[0]} verb_ir", argv, verb, want) for label, argv, _, want in runs if label == argv[0]]
    runs.append(("deconvolve", ["deconvolve", "--recorded_wav_file_path", str(recorded),
                                "--sweep_wav_file_path", str(sweep)], None, (0, 0)))

    def run(argv):
        return run_cli_text(torch, cli_main, argv)

    results = {}
    for i, (label, argv, wav, want) in enumerate(runs):
        def full(name):
            if wav is None:
                return argv + ["--output_ir_wav_file_path", str(out_dir / f"ir_{name}.wav")]
            return [argv[0], "--input", str(wav), *argv[1:], "--json", str(out_dir / f"{i}_{name}.json")]

        torch.cuda.reset_peak_memory_stats(dev)
        (cold, kernel_out), launches = read_launches(counters, lambda: run(full("kernel")))
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        if (launches["edc"], launches["stft"], launches["karplus"], launches["pool"], launches["dbfit"]) != (
                *want, 0, 0, 0):
            raise AssertionError(f"{label}: launches {launches}, expected K1 {want[0]}, K2 {want[1]}, K3 0, K4 0, K5 0")
        warm, _ = run(full("kernel"))
        busy = device_busy(torch, lambda: run(full("kernel"))) if wav != verb else None
        with plain_versions():
            plain, plain_out = run(full("plain"))
        if wav is None:
            a = wavfile.read(out_dir / "ir_kernel.wav")[1]
            b = wavfile.read(out_dir / "ir_plain.wav")[1]
            if kernel_out.splitlines()[1:] != plain_out.splitlines()[1:] or not np.array_equal(a, b):
                raise AssertionError("deconvolve: the kernel run and the plain run differ")
            if not (np.all(np.isfinite(a)) and a.shape[1] == 2):
                raise AssertionError(f"deconvolve: IR {a.shape} not finite stereo")
        else:
            cmd = argv[0]
            assert_summaries_agree(
                plain_out.split("\n", 1)[1], kernel_out.split("\n", 1)[1], *SUMMARY_TOLERANCES[cmd], label
            )
            ours = json.loads((out_dir / f"{i}_kernel.json").read_text())
            ref = json.loads((out_dir / f"{i}_plain.json").read_text())
            if json_skeleton(ours) != json_skeleton(ref):
                raise AssertionError(f"{label}: JSON keys of the kernel run and the plain run differ")
        launches_by_path[label] = launches
        results[label] = {"cold_s": cold, "warm_s": warm, "plain_s": plain, "peak_device_memory_gib": peak,
                          "launches": launches}
        if busy is not None:
            results[label]["warm_profiled"] = busy
        log(f"per-file {label}: cold {cold:.3f} s, warm {warm:.3f} s, plain {plain:.3f} s, "
            f"peak {peak:.3f} GiB, launches {launches}; kernel run == plain run")
        if busy is not None:
            log(f"  warm under the profiler: {busy}")
        if label == argv[0] and wav == tap:
            log("  " + kernel_out.rstrip().replace("\n", "\n  "))

    # the golden IR on the card against the reference tool's summaries
    golden = out_dir / "golden.wav"
    write_wav_pcm16(golden, golden_utils.make_golden_ir(), SR)
    for cmd, tol in SUMMARY_TOLERANCES.items():
        # the fixtures hold the analyses' default settings: decay without EDT
        extra = ["--no-compute_edt"] if cmd == "decay" else []
        _, text = run([cmd, "--input", str(golden), "--no-show" if cmd == "groupdelay" else "--no_show", *extra])
        fixture = REPO / "tests" / "golden" / "reference" / f"{FIXTURES.get(cmd, cmd)}.txt"
        assert_summaries_agree(fixture.read_text(), text, *tol, f"{cmd} golden IR vs reference")
    log("per-file: the golden IR's eight summaries on the card agree with the reference tool's")
    return results

def zplane_lines(text: str) -> list:
    """(channel, poles, max|p|, median|p|, unstable) of each line of a
    z-plane summary."""
    pat = re.compile(r"- (\S+): poles=(\d+), max\|p\|=([\d.]+), median\|p\|=([\d.]+), unstable\(\|p\|>=1\)=(\d+)")
    rows = [pat.match(line) for line in text.splitlines()[1:]]
    if not rows or not all(rows):
        raise AssertionError(f"z-plane summary not understood:\n{text}")
    return [(m.group(1), int(m.group(2)), float(m.group(3)), float(m.group(4)), int(m.group(5))) for m in rows]


def compare_zplane(card: str, cpu: str, label: str) -> list:
    """The card's z-plane summary against the CPU's: channels and pole
    counts exact, radii within REST_TOLERANCES["zplane"]; returns the
    channels whose unstable-pole count differs (logged, a finding)."""
    rel, abs_ = REST_TOLERANCES["zplane"]
    flips = []
    for a, b in zip(zplane_lines(card), zplane_lines(cpu), strict=True):
        if a[:2] != b[:2]:
            raise AssertionError(f"{label}: pole counts differ: {a} vs {b}")
        for x, y in zip(a[2:4], b[2:4]):
            if abs(x - y) > max(abs_, rel * max(abs(x), abs(y))):
                raise AssertionError(f"{label}: radii differ: {a} vs {b}")
        if a[4] != b[4]:
            flips.append({"channel": a[0], "card": a[4], "cpu": b[4]})
    return flips


def ar_gram_check(torch, tap: Path, dev) -> dict:
    """The AR Gram of zplane's default fit of the tap (order 256, the
    trimmed and peak-normalised stereo segment) alone: CUDA-event time of
    one call, its bound (the float32 products over the valid rows at 67
    TFLOP/s, or the segment read once and the Gram written once), the
    float64 Gram of the same segment on the card, and the peak memory."""
    from _ar_reference import ar_normal_equations_f64, relative_frobenius

    from audio_analysis_tpu_torch.analyses._common import FileDsp
    from audio_analysis_tpu_torch.ops import spectral

    dsp = FileDsp.from_wav_file(tap, False, dev)
    aligned = dsp.aligned(True, 0.0, None)
    seg, lengths = aligned.samples, aligned.length
    seg = seg / seg.abs().amax(dim=-1, keepdim=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    got = spectral.ar_normal_equations(seg, lengths, AR_ORDER)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
    ms = time_ms(lambda: spectral.ar_normal_equations(seg, lengths, AR_ORDER))
    t0 = time.perf_counter()
    gram, moment = ar_normal_equations_f64(seg, lengths, AR_ORDER)
    torch.cuda.synchronize()
    f64_s = time.perf_counter() - t0
    err = relative_frobenius(got.gram, gram)
    moment_err = relative_frobenius(got.moment[:, None, :], moment[:, None, :])
    rows = sum(max(0, min(int(n), seg.shape[-1]) - AR_ORDER) for n in lengths.tolist())
    flops = 2.0 * rows * (AR_ORDER * AR_ORDER + AR_ORDER)
    b, by = bound(seg.numel() * 4 + got.gram.numel() * 4 + got.moment.numel() * 4, flops)
    out = {"shape": list(seg.shape), "order": AR_ORDER, "rows": rows, "ms": ms, "bound_ms": b, "bound_by": by,
           "bound_share": b / ms, "flop": flops, "tflop_per_s": flops / ms / 1e9, "peak_gib": peak,
           "rel_frobenius_vs_f64": err, "moment_rel_err_vs_f64": moment_err, "f64_reference_s": f64_s}
    log(f"AR Gram ({seg.shape[0]}, {seg.shape[-1]}) order {AR_ORDER}: {ms:.3f} ms, bound {b:.3f} ms ({by}), "
        f"{b / ms:.0%} of bound, {flops / ms / 1e9:.1f} TFLOP/s; peak {peak:.3f} GiB; relative Frobenius "
        f"error against float64 on the card {err:.3g} (moment {moment_err:.3g})")
    if not err <= GRAM_MAX_REL_ERR:
        raise AssertionError(f"AR Gram: relative Frobenius error {err} against float64 > {GRAM_MAX_REL_ERR}")
    return out


def per_file_rest(torch, cli_main, root: Path, dev, counters, launches_by_path: dict) -> dict:
    """Phase 9: filter, the --exact-grid runs, zplane and ir through the
    analyse CLI, and the gen CLI, on the card, each cold, warm, under
    torch.profiler (on the tap) and against --device cpu; K1 and K2 must
    launch 0 times in each. The AR Gram alone against its bound and a
    float64 Gram."""
    import shutil

    import numpy as np
    from scipy.io import wavfile

    from audio_analysis_tpu_torch.cli.gen_cli import main as gen_main
    from audio_analysis_tpu_torch.signals import torchgen

    from _summary_parity import assert_summaries_agree, json_skeleton

    out_dir = REPO / "build" / "chip_smoke_per_file_rest"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    tap = root / "taps" / "tap00.wav"
    verb = REPO / "examples" / "gallery" / "verb_ir.wav"
    zero = {c.name: 0 for c in counters}

    # (label, argv without --input / --json / --device, tolerance key)
    runs = [
        ("filter", ["filter", "--no_show"], "filter"),
        ("filter --exact-grid", ["filter", "--no_show", "--exact-grid"], "exact_filter"),
        ("fr --exact-grid", ["fr", "--no_show", "--exact-grid"], "exact_fr"),
        ("groupdelay --exact-grid", ["groupdelay", "--no-show", "--exact-grid"], "exact_groupdelay"),
        ("zplane", ["zplane", "--no-show"], "zplane"),
        ("zplane --zeros --ridge 1e-5", ["zplane", "--no-show", "--zeros", "--ridge", "1e-5"], "zplane"),
        ("ir", ["ir", "--no_show"], "ir"),
    ]
    results = {"unstable_count_flips": {}}
    for wav, where in ((tap, "tap"), (verb, "verb_ir")):
        for i, (label, argv, tol) in enumerate(runs):
            key = f"{label} {where}" if wav == verb else label

            def full(name, device):
                return [argv[0], "--input", str(wav), *argv[1:], "--json", str(out_dir / f"{where}{i}_{name}.json"),
                        "--device", device]

            torch.cuda.reset_peak_memory_stats(dev)
            (cold, card_out), launches = read_launches(counters, lambda: run_cli_text(torch, cli_main, full("card", "cuda")))
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            if launches != zero:
                raise AssertionError(f"{key}: K1/K2 launches {launches}, expected none")
            launches_by_path[key] = launches
            warm, _ = run_cli_text(torch, cli_main, full("card", "cuda"))
            entry = {"cold_s": cold, "warm_s": warm, "peak_device_memory_gib": peak, "launches": launches}
            if wav == tap:
                entry["warm_profiled"] = device_busy(torch, lambda: run_cli_text(torch, cli_main, full("card", "cuda")))
            # zplane at order 256 on the CPU: on the shorter verb_ir.wav only
            if not (argv[0] == "zplane" and wav == tap):
                entry["cpu_s"], cpu_out = run_cli_text(torch, cli_main, full("cpu", "cpu"))
                ours = json.loads((out_dir / f"{where}{i}_card.json").read_text())
                ref = json.loads((out_dir / f"{where}{i}_cpu.json").read_text())
                if json_skeleton(ours) != json_skeleton(ref):
                    raise AssertionError(f"{key}: JSON keys of the card run and the CPU run differ")
                if argv[0] == "ir":
                    if ours != ref or card_out.splitlines()[1:] != cpu_out.splitlines()[1:]:
                        raise AssertionError(f"{key}: the card run and the CPU run differ")
                elif argv[0] == "zplane":
                    flips = compare_zplane(card_out.split("\n", 1)[1], cpu_out.split("\n", 1)[1], key)
                    if flips:
                        results["unstable_count_flips"][key] = flips
                        log(f"  {key}: unstable-pole count differs between the card and the CPU: {flips}")
                else:
                    assert_summaries_agree(
                        cpu_out.split("\n", 1)[1], card_out.split("\n", 1)[1], *REST_TOLERANCES[tol], key
                    )
            results[key] = entry
            log(f"per-file {key}: cold {cold:.3f} s, warm {warm:.3f} s, cpu {entry.get('cpu_s', float('nan')):.3f} s, "
                f"peak {peak:.3f} GiB, launches {launches}")
            if "warm_profiled" in entry:
                log(f"  warm under the profiler: {entry['warm_profiled']}")
            if wav == tap or argv[0] == "zplane":
                log("  " + card_out.rstrip().replace("\n", "\n  "))

    results["ar_gram"] = ar_gram_check(torch, tap, dev)

    # gen: the default tone set in stereo, and Karplus-Strong at 110 Hz
    # (L = 436, 220 periods) and at 4 kHz (L = 12, 7999 periods); each makes
    # one K3 launch (the tone set's Karplus-Strong pluck is at 110 Hz)
    gen_runs = [
        ("gen all --channel_mode stereo", ["--channel_mode", "stereo"], ["all"]),
        ("gen karplus_pluck --freq 110", [], ["karplus_pluck", "--freq", "110"]),
        ("gen karplus_pluck --freq 4000", [], ["karplus_pluck", "--freq", "4000"]),
    ]
    for label, flags, command in gen_runs:
        dirs = {side: out_dir / "gen" / label.replace(" ", "_") / side for side in ("card", "cpu")}

        def gen(side):
            device = "cuda" if side == "card" else "cpu"
            return run_cli_text(torch, gen_main, ["--output-dir", str(dirs[side]), *flags, "--device", device,
                                                  *command])

        (cold, card_out), launches = read_launches(counters, lambda: gen("card"))
        if launches != {**zero, "karplus": 1}:
            raise AssertionError(f"{label}: launches {launches}, expected K3 1 and no other")
        launches_by_path[label] = launches
        warm, _ = gen("card")
        busy = device_busy(torch, lambda: gen("card"))
        cpu_s, cpu_out = gen("cpu")
        if card_out.replace(str(dirs["card"]), "D") != cpu_out.replace(str(dirs["cpu"]), "D"):
            raise AssertionError(f"{label}: stdout differs between the card and the CPU")
        names = sorted(p.name for p in dirs["cpu"].glob("*.wav"))
        if not names or sorted(p.name for p in dirs["card"].glob("*.wav")) != names:
            raise AssertionError(f"{label}: WAV files {names}")
        for name in names:
            if (dirs["card"] / name).read_bytes() != (dirs["cpu"] / name).read_bytes():
                raise AssertionError(f"{label}: {name} differs between the card and the CPU")
        results[label] = {"cold_s": cold, "warm_s": warm, "cpu_s": cpu_s, "warm_profiled": busy,
                          "launches": launches, "wavs_identical": True}
        log(f"{label}: cold {cold:.3f} s, warm {warm:.3f} s, cpu {cpu_s:.3f} s, {len(names)} WAVs identical to "
            f"the CPU run; launches {launches}; warm under the profiler: {busy}")

    # the Karplus-Strong recurrence alone on the card, by host clock ending
    # in a synchronize (comparable with the per-period loop's numbers)
    ks = {}
    for freq in (110.0, 4000.0):
        delay = max(2, int(round(SR / freq)))
        init = torch.randn(delay, generator=torch.Generator().manual_seed(1)).to(dev)

        def one():
            torchgen.karplus_strong_scan(init, 2 * SR, 0.996, 0.5)
            torch.cuda.synchronize()

        one()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            one()
            walls.append(time.perf_counter() - t0)
        ks[f"{freq:.0f}"] = {"delay_len": delay, "steps": -(-2 * SR // delay) - 1, "wall_s": walls,
                             "profiled": device_busy(torch, one)}
        log(f"Karplus-Strong {freq:.0f} Hz (L = {delay}): {min(walls) * 1e3:.2f}-{max(walls) * 1e3:.2f} ms; "
            f"under the profiler {ks[f'{freq:.0f}']['profiled']}")
    results["karplus_strong_alone"] = ks
    err, shapes, clocks = karplus_check(torch, dev)
    results["karplus_kernel"] = {"max_abs_err": err, "shapes": shapes, "sm_clock_mhz_samples": clocks,
                                 "device_events_per_call": 1}
    return results


# K3's delay lengths on the card: the one-thread path (1, 2), the warp
# path's ends (31, 32), the register path's one warp (33, 64) and its
# warps (436, 2400), and the gen CLI's 4 kHz (12), 110 Hz (436) and 20 Hz
# (2400)
KARPLUS_DELAYS = (1, 2, 12, 31, 32, 33, 64, 436, 2400)
# K3's chain floor: 5 dependent fp32 operations a period, 4 cycles each
# (Hopper's FADD / FMUL latency)
KS_CHAIN_CYCLES = 5 * 4


@contextlib.contextmanager
def sm_clock_samples():
    """The SM clocks (MHz) that nvidia-smi reads every 50 ms while the
    block runs; the sampler is stopped on the way out."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits", "-lms", "50"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    samples: list = []
    try:
        yield samples
    finally:
        proc.terminate()
        try:
            out, _ = proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        samples.extend(float(v) for v in out.split() if v.strip().replace(".", "", 1).isdigit())


def karplus_check(torch, dev) -> tuple:
    """K3 against its plain version on the card, bit for bit (int32
    patterns): at the gen CLI's calls (one string, 2 s: L = 12 at 4 kHz,
    the kernels line's own path, and L = 436 at 110 Hz) and at every L of
    KARPLUS_DELAYS with 1 and 8 strings and 2 s + 1 sample (a multiple of
    none of them). CUDA-event times of both (the plain loop's include its
    host enqueue, which is what it costs), the bound (the line read and the
    output written once at 3.35 TB/s, or 6 fp32 operations a sample at 67
    TFLOP/s) and the chain floor: periods x KS_CHAIN_CYCLES at the median SM
    clock that nvidia-smi read while the kernels were timed. Returns (max
    abs error, per-call shapes, the clock samples)."""
    from audio_analysis_tpu_torch.signals import torchgen

    g = torch.Generator().manual_seed(3)
    cases = [(1, 12, 2 * SR, None), (1, 436, 2 * SR, "gen karplus_pluck --freq 110")]
    cases += [(strings, delay, 2 * SR + 1, "karplus_strong_alone") for delay in KARPLUS_DELAYS for strings in (1, 8)]
    worst, shapes = 0.0, []
    with sm_clock_samples() as clocks:
        for strings, delay, total, path in cases:
            init = (torch.rand(strings, delay, generator=g) * 2.0 - 1.0).to(dev)

            def kernel():
                return torchgen.karplus_strong_batch_cuda(init, total, 0.996, 0.5)

            def plain():
                return torchgen.karplus_strong_batch_plain(init, total, 0.996, 0.5)

            got, ref = kernel(), plain().contiguous()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
                raise AssertionError(f"K3 karplus ({strings}, {delay}, {total}): not bit-equal to the plain version "
                                     f"(max err {err})")
            worst = max(worst, err)
            k = time_ms(kernel, reps=9)
            p = time_ms(plain, reps=1 if delay <= 2 else 2)  # 48,000-96,000 vector steps a call at L <= 2
            b, by = bound(strings * (delay + total) * 4, strings * total * 6.0)
            periods = -(-total // delay) - 1
            shape = {"shape": [strings, delay, total], "periods": periods, "ms": k, "plain_ms": p, "bound_ms": b,
                     "bound_by": by, "library_ms": None, "us_per_period": k * 1e3 / max(periods, 1)}
            shapes.append(shape if path is None else {**shape, "path": path})
    if not clocks:
        raise AssertionError("nvidia-smi read no SM clock while K3 ran")
    mhz = statistics.median(clocks)
    for shape in shapes:
        floor = shape["periods"] * KS_CHAIN_CYCLES / (mhz * 1e3)
        shape.update(chain_floor_ms=floor, sm_clock_mhz=mhz, x_chain_floor=shape["ms"] / floor if floor else None)
        strings, delay, total = shape["shape"]
        log(f"K3 karplus ({strings} strings, L = {delay}, {total} samples, {shape['periods']} periods): bit-equal to "
            f"the plain version; kernel {shape['ms']:.4f} ms ({shape['us_per_period'] * 1e3:.1f} ns a period), chain "
            f"floor {floor:.4f} ms at {mhz:.0f} MHz (x{shape['ms'] / floor if floor else float('nan'):.2f}), plain "
            f"{shape['plain_ms']:.3f} ms, bound {shape['bound_ms'] * 1e3:.3f} us ({shape['bound_by']})")
    return worst, shapes, clocks


def count_decodes(fn):
    """(fn(), {"native": n, "scipy": m}): the WAV decodes fn makes, counted
    by wrapping the native decoder's read_wav and scipy's wavfile.read."""
    import scipy.io.wavfile

    from audio_analysis_tpu_torch.io import native

    counts = {"native": 0, "scipy": 0}

    def counted(name, read):
        def wrapped(*args, **kwargs):
            counts[name] += 1
            return read(*args, **kwargs)

        return wrapped

    with mock.patch.object(native, "read_wav", counted("native", native.read_wav)), \
            mock.patch.object(scipy.io.wavfile, "read", counted("scipy", scipy.io.wavfile.read)):
        result = fn()
    return result, counts


def embedded_images(md_path: Path) -> set:
    """The PNG names a report's markdown embeds."""
    return set(re.findall(r"!\[[^\]]*\]\(([^)]+)\)", md_path.read_text()))


def check_tap_pngs(reports: Path, taps) -> None:
    """Every tap's PNG files are exactly the ones its markdown embeds."""
    for tap in taps:
        folder = reports / tap
        pngs = {q.name for q in folder.glob("*.png")}
        if not pngs or pngs != embedded_images(folder / f"{tap}_report.md"):
            raise AssertionError(f"{reports.name}/{tap}: PNGs {sorted(pngs)} against the markdown's images")


def pooled_image_check(torch, tap: Path, dev) -> dict:
    """ops.display.pooled_log_freq_image alone on the report's plane (the
    tap's 4096-point dB STFT, (2, 2041, 2049)): CUDA-event time, peak
    memory, the image against the one computed from the same plane on the
    CPU, its bound (the selected bins read once and the int16 image
    written once at 3.35 TB/s), and one call under torch.profiler (device
    busy time and the largest device items). Then K4 alone (pool_check)."""
    import numpy as np

    from audio_analysis_tpu_torch.analyses._common import FileDsp
    from audio_analysis_tpu_torch.ops import display
    from audio_analysis_tpu_torch.ops import stft as stft_ops

    dsp = FileDsp.from_wav_file(tap, False, dev)
    _, seg_lens = dsp.aligned_host_meta(True, 0.0, None)
    plane = dsp.stft_db(True, 0.0, None, 4096, 512, True, -120.0).mag_db
    frames = np.array([stft_ops.num_frames_static(int(n), 4096, 512) for n in seg_lens], np.int64)
    args = (frames, 4096, SR, 20.0, 20_000.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    images, p995, p5 = display.pooled_log_freq_image(plane, *args)
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
    ms = time_ms(lambda: display.pooled_log_freq_image(plane, *args))
    ref_images, ref_p995, ref_p5 = display.pooled_log_freq_image(plane.cpu(), *args)
    if not all(np.array_equal(a, b) for a, b in zip(images, ref_images)):
        raise AssertionError("pooled display image: card and CPU differ")
    if not (np.abs(p995 - ref_p995).max() <= 1 / 128 and np.abs(p5 - ref_p5).max() <= 1 / 128):
        raise AssertionError(f"pooled display percentiles: card {p995} {p5}, CPU {ref_p995} {ref_p5}")
    i0, i1 = display.freq_selection(4096, SR, 20.0, 20_000.0)
    read = plane.shape[0] * plane.shape[1] * (i1 - i0) * 4
    written = sum(im.size for im in images) * 2
    b, by = bound(read + written, 0.0)
    busy = device_busy(torch, lambda: display.pooled_log_freq_image(plane, *args))
    col_pool = -(-int(frames.max()) // 1200) if int(frames.max()) > 1800 else 1
    key = (4096, SR, i0, i1, 20.0, 20_000.0, 720)
    nf = torch.from_numpy(frames).to(dev)

    def wall_ms(fn) -> list:
        walls = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return walls

    call_walls = wall_ms(lambda: display.pooled_log_freq_image(plane, *args))
    wrapper_walls = wall_ms(lambda: display._pooled_image(plane, nf, key, col_pool))
    out = {"plane": list(plane.shape), "image": [list(im.shape) for im in images], "ms": ms, "bound_ms": b,
           "bound_by": by, "bound_share": b / ms, "peak_gib": peak, "p995_db": p995.tolist(), "p5_db": p5.tolist(),
           "profiled": busy, "call_wall_ms": call_walls, "wrapper_wall_ms": wrapper_walls,
           "copy_and_host_ms": statistics.median(call_walls) - statistics.median(wrapper_walls)}
    log(f"pooled display image {tuple(plane.shape)} -> {[im.shape for im in images]}: {ms:.3f} ms, bound "
        f"{b * 1e3:.1f} us ({by}), {b / ms:.2%} of bound; peak {peak:.3f} GiB; card == CPU; host clock: the call "
        f"{min(call_walls):.3f}-{max(call_walls):.3f} ms, its K4 wrapper {min(wrapper_walls):.3f}-"
        f"{max(wrapper_walls):.3f} ms, the copy and the host's work {out['copy_and_host_ms']:.3f} ms")
    log(f"  under the profiler: {busy}")
    out["k4"] = pool_check(torch, display, plane, frames, dev)
    return out


def pool_corner_planes(torch, plane, i0: int, i1: int) -> dict:
    """The report's plane with channel 0's selected bins cornered for the
    percentile selection, from seed 11: a floor (-120 dB exactly) in 60% of
    the cells; every cell below -0.5 dB but 2% at +0 and -0 (the 99.5th
    percentile on signed zeros); 1% each NaN, +inf and -inf."""
    g = torch.Generator(device=plane.device).manual_seed(11)
    region = (plane.shape[1], i1 - i0)

    def cells(share):
        return torch.rand(region, generator=g, device=plane.device) < share

    floor = plane.clone()
    floor[0, :, i0:i1] = torch.where(cells(0.6), torch.tensor(-120.0, device=plane.device), floor[0, :, i0:i1])
    zeros = plane.clone()
    sub = torch.clamp(zeros[0, :, i0:i1], max=-0.5)
    zero, sign = cells(0.02), cells(0.5)
    sub = torch.where(zero & sign, torch.tensor(0.0, device=plane.device), sub)
    zeros[0, :, i0:i1] = torch.where(zero & ~sign, torch.tensor(-0.0, device=plane.device), sub)
    odd = plane.clone()
    pick = torch.rand(region, generator=g, device=plane.device)
    sub = odd[0, :, i0:i1]
    for k, value in enumerate((float("nan"), float("inf"), float("-inf"))):
        sub = torch.where((pick >= 0.01 * k) & (pick < 0.01 * (k + 1)), torch.tensor(value, device=plane.device), sub)
    odd[0, :, i0:i1] = sub
    return {"a floor in 60% of the cells": floor, "+-0 at the 99.5th percentile": zeros, "NaN and +-inf cells": odd}


def pool_check(torch, display, plane, frames, dev) -> dict:
    """K4 (ops.display._pooled_image on the card) against its plain
    version on the same card plane, int16 for int16: the report's call
    (the tap's valid frames, 720 rows, its column pooling), column pooling
    1 and 3 with the two channels' valid counts apart, a channel with no
    valid frame, and the report's call on pool_corner_planes. CUDA-event
    times of the wrapper (a memset and three launches), of its C entry
    alone, of the plain version (the pyramid and a sort), and of
    torch.nanquantile per channel on the valid selected region for the two
    percentiles alone (`library_ms`, finite planes); the device events of
    one wrapper call under torch.profiler. The bound is
    pooled_image_check's: the selected bins of the valid frames read once
    and the int16 image written once."""
    from audio_analysis_tpu_torch import _build

    t = plane.shape[1]
    i0, i1 = display.freq_selection(4096, SR, 20.0, 20_000.0)
    key = (4096, SR, i0, i1, 20.0, 20_000.0, 720)
    report_pool = -(-int(frames.max()) // 1200) if int(frames.max()) > 1800 else 1
    report_valid = tuple(int(v) for v in frames)
    cases = [(plane, report_valid, report_pool, None), (plane, (t, 900), 1, "split valid counts"),
             (plane, (t - 7, t // 3), 3, "split valid counts"), (plane, (t, 0), 2, "a channel with no valid frame")]
    cases += [(p, report_valid, report_pool, label) for label, p in pool_corner_planes(torch, plane, i0, i1).items()]
    lib, worst, shapes = _build.library(), 0, []
    qs = torch.tensor([0.995, 0.05], dtype=torch.float32, device=dev)
    for x, valid, col_pool, path in cases:
        nf = torch.tensor(valid, dtype=torch.int64, device=dev)
        got = display._pooled_image(x, nf, key, col_pool)
        ref = display._pooled_image_plain(x, nf, key, col_pool)
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.equal(got, ref):
            raise AssertionError(f"K4 pool {valid} col_pool {col_pool} ({path}): not equal to the plain version "
                                 f"(percentiles {got[:, :2, -1].tolist()} against {ref[:, :2, -1].tolist()})")
        worst = max(worst, int((got.int() - ref.int()).abs().max()))
        spans = display._row_spans_on(key, dev)
        scratch = torch.empty(lib.aa_pool_scratch_bytes(x.shape[0]), dtype=torch.uint8, device=dev)
        out = torch.empty_like(got)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def launch_alone():
            _build.check(lib.aa_pool_image(x.data_ptr(), nf.data_ptr(), spans.data_ptr(), scratch.data_ptr(),
                                           out.data_ptr(), x.shape[0], t, x.shape[2], i0, i1 - i0, 720, col_pool,
                                           stream), "pool kernel")

        k = time_ms(lambda: display._pooled_image(x, nf, key, col_pool), reps=15)
        alone = time_ms(launch_alone, reps=15)
        if not torch.equal(out, got):
            raise AssertionError(f"K4 pool {valid}: the C entry alone and the wrapper differ")
        p = time_ms(lambda: display._pooled_image_plain(x, nf, key, col_pool))
        library = None
        if bool(torch.isfinite(x).all()):
            regions = [x[c, :v, i0:i1].reshape(-1) for c, v in enumerate(valid) if v > 0]

            def percentiles_alone():
                return [torch.nanquantile(r, qs) for r in regions]

            library = time_ms(percentiles_alone)
        events = device_busy(torch, lambda: display._pooled_image(x, nf, key, col_pool))
        read = sum(min(v, t) for v in valid) * (i1 - i0) * 4
        b, by = bound(read + got.numel() * 2, 0.0)
        shape = {"shape": [*x.shape, 720], "valid": list(valid), "col_pool": col_pool, "ms": k,
                 "launch_alone_ms": alone, "plain_ms": p, "bound_ms": b, "bound_by": by, "library_ms": library,
                 "device_events_per_call": events["device_events"], "device_busy_ms": events["device_busy_ms"],
                 "host_launch_calls_per_call": events["host_calls"]["cudaLaunchKernel"]
                 + events["host_calls"]["cudaMemsetAsync"],
                 "percentiles_i16": got[:, :2, -1].tolist()}
        shapes.append(shape if path is None else {**shape, "path": path})
        log(f"K4 pool {tuple(x.shape)} valid {valid} col_pool {col_pool}{'' if path is None else ' (' + path + ')'}: "
            f"equal to the plain version; wrapper {k:.4f} ms (its C entry alone {alone:.4f} ms; under the profiler "
            f"{shape['host_launch_calls_per_call']} launch and memset calls, {events['device_events']} device events, "
            f"{events['device_busy_ms']:.4f} ms busy), plain {p:.3f} ms, "
            f"percentiles alone by torch.nanquantile {'-' if library is None else f'{library:.3f} ms'}, "
            f"bound {b * 1e3:.1f} us ({by})")
    return {"max_abs_err": float(worst), "shapes": shapes}


def plots_phase(torch, cli_main, root: Path, dev, counters, launches_by_path: dict) -> dict:
    """Phase 10: the plot reports. The report suite in process with its
    render jobs recorded (kernels against plain versions), the golden IR's
    report against tests/golden/verb_report_golden.md, the display pooling
    alone, and the plot bundle runner over a 4-tap view with its jobs
    recorded; where matplotlib imports, `report` and the plot `bundle`
    through the CLI entry with their PNGs, else `report` must exit naming
    matplotlib."""
    import contextlib
    import io
    import shutil

    import golden_utils
    from _render_jobs import RecordingPlotWorker, compare_jobs

    from audio_analysis_tpu_torch.io import materialize_bundle_view
    from audio_analysis_tpu_torch.io import wav as wav_io
    from audio_analysis_tpu_torch.io.wav import write_wav_pcm16
    from audio_analysis_tpu_torch.report import bundle as bundle_module
    from audio_analysis_tpu_torch.report.report import ReportSettings, run_report_from_wav_file

    try:
        import matplotlib

        mpl = matplotlib.__version__
    except ImportError:
        mpl = None
    out = {"matplotlib": mpl}
    log(f"plots: matplotlib {mpl}")
    out_dir = REPO / "build" / "chip_smoke_plots"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    tap = root / "taps" / "tap00.wav"
    names = [f"tap{i:02d}" for i in range(4)]
    view = materialize_bundle_view([str(root / "taps" / f"{t}.wav") for t in names], out_dir / "bundle4")

    def recorded(base: Path, wav: Path = tap):
        jobs = RecordingPlotWorker()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = run_report_from_wav_file(wav, base, ReportSettings(), jobs, dev)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, result, jobs

    # 10.1 the report in process, figures recorded: K1 and K2 twice each,
    # the kernel run against the plain run; the tap decoded once in a cold
    # report (the read cache emptied first: earlier phases read the tap)
    # and not at all in a warm one over the unchanged file
    wav_io._RAW_CACHE.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    ((cold, kernel_md, kernel_jobs), launches), cold_decodes = count_decodes(
        lambda: read_launches(counters, lambda: recorded(out_dir / "rec_k" / "tap00")))
    if (launches["edc"], launches["stft"], launches["karplus"]) != (2, 2, 0) or launches["pool"] < 1:
        raise AssertionError(f"report (figures recorded): launches {launches}, expected K1 2, K2 2, K3 0, K4 1+")
    launches_by_path["report (figures recorded)"] = launches
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    warm, warm_decodes = count_decodes(lambda: [recorded(out_dir / "rec_k" / "tap00")[0] for _ in range(3)])
    if sum(cold_decodes.values()) != 1 or sum(warm_decodes.values()) != 0:
        raise AssertionError(f"report decodes: cold {cold_decodes} (expected 1), 3 warm {warm_decodes} (expected 0)")
    out["report_decodes"] = {"cold": cold_decodes, "warm_3_reports": warm_decodes, "warm_s": warm,
                             "card": card_line()}
    log(f"report decodes of the tap: cold {cold_decodes}, 3 warm reports {warm_decodes}; warm "
        f"{min(warm):.3f}-{max(warm):.3f} s; {out['report_decodes']['card']}")
    busy = device_busy(torch, lambda: recorded(out_dir / "rec_k" / "tap00"))
    with plain_versions():
        plain, plain_md, plain_jobs = recorded(out_dir / "rec_p" / "tap00")
    worst = compare_jobs(plain_jobs.jobs, kernel_jobs.jobs)
    compare_markdown(kernel_md.summary_markdown, plain_md.summary_markdown.replace("rec_p", "rec_k"), "report")
    out["report_recorded"] = {"cold_s": cold, "warm_s": warm, "plain_s": plain, "peak_device_memory_gib": peak,
                              "launches": launches, "warm_profiled": busy, "render_jobs_worst_ratio": worst}
    log(f"report (figures recorded): cold {cold:.3f} s, warm {min(warm):.3f}-{max(warm):.3f} s, plain {plain:.3f} s, "
        f"peak {peak:.3f} GiB, launches {launches}; {len(kernel_jobs.jobs)} render jobs of the kernel run within "
        f"tolerance of the plain run's (worst ratio {max(worst.values()):.3g}); markdown agrees")
    log(f"  warm under the profiler: {busy}")

    # 10.2 the golden IR's report on the card against the golden markdown
    golden = out_dir / "golden_ir.wav"
    write_wav_pcm16(golden, golden_utils.make_golden_ir(), SR)
    _, golden_md, _ = recorded(out_dir / "golden" / "golden", golden)
    golden_utils.compare_reports(
        (REPO / "tests" / "golden" / "verb_report_golden.md").read_text(), golden_md.summary_markdown
    )
    log("report: the golden IR's report on the card agrees with tests/golden/verb_report_golden.md")

    # 10.3 the display pooling alone
    out["pooled_image"] = pooled_image_check(torch, tap, dev)

    # 10.4 the plot bundle runner over 4 taps, figures recorded: 2 and 2
    # launches a tap
    with mock.patch.object(bundle_module, "make_plot_worker", lambda *a: RecordingPlotWorker()):
        t0 = time.perf_counter()
        _, launches = read_launches(counters, lambda: bundle_module.run_bundle_report(
            view, bundle_module.BundleRunSettings(reports_subdir="reports_recorded"), dev))
        recorded_s = time.perf_counter() - t0
    if (launches["edc"], launches["stft"], launches["karplus"]) != (8, 8, 0) or launches["pool"] < 4:
        raise AssertionError(f"plot bundle (figures recorded): launches {launches}, expected 8, 8, 0 and 4+")
    launches_by_path["plot bundle (figures recorded)"] = launches
    out["bundle_recorded_s"] = recorded_s
    log(f"plot bundle of 4 taps (figures recorded): {recorded_s:.3f} s, launches {launches}")

    if mpl is None:
        log("plots: matplotlib does not import on this host; no PNG is drawn, and `report`, the plot "
            "`bundle` and `watch --plots` must exit naming it")
        for argv in (["report", "--input", str(tap), "--output", str(out_dir / "cli" / "tap00")],
                     ["bundle", "--input", str(view), "--reports-subdir", "reports_cli"],
                     ["watch", "--input", str(view), "--plots", "--max-bundles", "1"]):
            text = io.StringIO()
            with contextlib.redirect_stderr(text), contextlib.redirect_stdout(text):
                try:
                    cli_main(argv)
                    code, message = 0, ""
                except SystemExit as exc:
                    code, message = exc.code, str(exc.code)
            if code in (0, None) or "matplotlib" not in message or (out_dir / "cli").exists() \
                    or (view / "reports_cli").exists() or (view / "reports").exists():
                raise AssertionError(f"{argv[0]} without matplotlib: exit {code!r}, {message!r}")
            out[f"{argv[0]}_without_matplotlib"] = message
        log(f"report, bundle and watch --plots without matplotlib exit: {message}")
        return out

    # 10.5 `report` through the CLI entry: cold, warm, plain, PNGs
    def cli_report(name: str):
        base = out_dir / "cli" / name / "tap00"
        wall, text = run_cli_text(torch, cli_main, ["report", "--input", str(tap), "--output", str(base)])
        md = base.parent / "tap00_report.md"
        if text.splitlines()[-1] != f"Wrote: {md}":
            raise AssertionError(f"report stdout ends {text.splitlines()[-1]!r}")
        pngs = {q.name for q in base.parent.glob("*.png")}
        if len(pngs) != 15 or pngs != embedded_images(md):
            raise AssertionError(f"report {name}: PNGs {sorted(pngs)}")
        return wall, md.read_text()

    torch.cuda.reset_peak_memory_stats(dev)
    (cold, kernel_text), launches = read_launches(counters, lambda: cli_report("cold"))
    if (launches["edc"], launches["stft"], launches["karplus"]) != (2, 2, 0) or launches["pool"] < 1:
        raise AssertionError(f"report: launches {launches}, expected K1 2, K2 2, K3 0, K4 1+")
    launches_by_path["report"] = launches
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    warm = [cli_report("warm")[0] for _ in range(2)]
    busy = device_busy(torch, lambda: cli_report("profiled"))
    with plain_versions():
        plain, plain_text = cli_report("plain")
    compare_markdown(kernel_text, plain_text.replace("/cli/plain/", "/cli/cold/"), "report CLI")
    out["report_cli"] = {"cold_s": cold, "warm_s": warm, "plain_s": plain, "peak_device_memory_gib": peak,
                         "launches": launches, "warm_profiled": busy}
    log(f"report: cold {cold:.3f} s, warm {min(warm):.3f}-{max(warm):.3f} s, plain {plain:.3f} s, peak {peak:.3f} "
        f"GiB, launches {launches}; 15 PNGs; kernel run == plain run")
    log(f"  warm under the profiler: {busy}")

    # 10.6 the plot bundle through the CLI entry: the thread worker, then a
    # pool of 2 processes, then --resume
    def cli_bundle(subdir: str, *extra: str):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli_main(["bundle", "--input", str(view), "--reports-subdir", subdir, *extra])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for label, subdir, extra in (("thread", "reports_thread", ()), ("processes 2", "reports_procs",
                                                                     ("--plot-processes", "2"))):
        wall, launches = read_launches(counters, lambda: cli_bundle(subdir, *extra))
        if (launches["edc"], launches["stft"], launches["karplus"]) != (8, 8, 0) or launches["pool"] < 4:
            raise AssertionError(f"plot bundle {label}: launches {launches}, expected 8, 8, 0 and 4+")
        launches_by_path[f"plot bundle ({label})"] = launches
        check_tap_pngs(view / subdir, names)
        timings = json.loads((view / subdir / "plot_timings.json").read_text())
        out[f"bundle_{label.replace(' ', '_')}"] = {"wall_s": wall, "launches": launches, "plot_timings": timings}
        log(f"plot bundle of 4 taps ({label}): {wall:.3f} s, launches {launches}; render seconds per kind "
            + json.dumps({k: v["seconds"] for k, v in timings.items()}))
    for t in names:
        compare_markdown((view / "reports_thread" / t / f"{t}_report.md").read_text(),
                         (view / "reports_procs" / t / f"{t}_report.md").read_text(), f"plot bundle {t}")
    wall, launches = read_launches(counters, lambda: cli_bundle("reports_thread", "--resume"))
    index = (view / "reports_thread" / "bundle_report.md").read_text()
    if any(launches.values()) or index.count("(cached)") != len(names):
        raise AssertionError(f"plot bundle --resume: launches {launches}, index\n{index}")
    launches_by_path["plot bundle --resume"] = launches
    out["bundle_resume_s"] = wall
    log(f"plot bundle --resume: every tap cached, 0 launches, {wall:.3f} s")

    # 10.7 watch --plots over the view: the engine run (one chunk: K1 2,
    # K2 2) and the plot reports (2 and 2 a tap) into reports_plots
    t0 = time.perf_counter()
    _, launches = read_launches(counters, lambda: cli_main(
        ["watch", "--input", str(view), "--plots", "--max-bundles", "1", "--interval", "0.05"]))
    wall = time.perf_counter() - t0
    if (launches["edc"], launches["stft"], launches["karplus"]) != (10, 10, 0) or launches["pool"] < 4:
        raise AssertionError(f"watch --plots: launches {launches}, expected 10, 10, 0 and 4+")
    launches_by_path["watch --plots"] = launches
    check_tap_pngs(view / "reports_plots", names)
    out["watch_plots_s"] = wall
    log(f"watch --plots over 4 taps: {wall:.3f} s, launches {launches}")
    return out


# ------------------------------------------------------- multi-device ----

# One rank of phase 11's job: `bundle --multi-host` through the CLI entry,
# three times in one process (cold, then warm twice, each with its own
# coordinator),
# the launch counters set to 0 before each run and read after it.
# A rank's gloo gathers send its payloads pickled (what all_gather_object
# serialises); the rank code counts those bytes.
RANK_CODE = r"""
import json, pickle, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from audio_analysis_tpu_torch.cli.analyse_cli import main
from audio_analysis_tpu_torch.engine import distributed, graphs
from audio_analysis_tpu_torch.ops import dbfit, display, edc, stft
from audio_analysis_tpu_torch.signals import torchgen

counters = (edc.EDC_KERNEL, stft.STFT_KERNEL, torchgen.KARPLUS_KERNEL, display.POOL_KERNEL, dbfit.DBFIT_KERNEL)
out_json, argv, addresses = sys.argv[2], sys.argv[3:-3], sys.argv[-3:]
real_analyze, real_gather, engine_s, sent = distributed.analyze_bundle_multi_host, distributed._all_gather, [], []

def timed_analyze(*args, **kwargs):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = real_analyze(*args, **kwargs)
    torch.cuda.synchronize()
    engine_s.append(time.perf_counter() - t0)
    return out

def counted_gather(obj):
    sent.append(len(pickle.dumps(obj)))
    return real_gather(obj)

distributed.analyze_bundle_multi_host = timed_analyze
distributed._all_gather = counted_gather
torch.empty(0, device="cuda:0")  # the allocator's statistics need a context
runs = []
for address in addresses:
    for counter in counters:
        counter.launches = 0
    sent.clear()
    torch.cuda.reset_peak_memory_stats(0)
    before = graphs.STEP_GRAPHS.stats()
    t0 = time.perf_counter()
    main(argv + ["--coordinator", address])
    torch.cuda.synchronize()
    after = graphs.STEP_GRAPHS.stats()
    runs.append({"wall_s": time.perf_counter() - t0, "engine_s": engine_s[-1],
                 "graphs": {k: after[k] - before[k] for k in ("captures", "replays")},
                 "launches": {c.name: c.launches for c in counters},
                 "peak_device_memory_gib": torch.cuda.max_memory_allocated(0) / 2**30,
                 "gather_bytes_sent": sum(sent), "gathers": len(sent)})
banned = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "audio_analysis_tpu"))
json.dump({"runs": runs, "banned_modules": banned, "device": str(distributed.rank_device("cuda"))},
          open(out_json, "w"))
"""
RANKS = 2
RANK_TIMEOUT_S = 300


def free_address() -> str:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def run_processes(commands, env) -> tuple:
    """(wall seconds, outputs) of processes run together; every output pipe
    is drained at once, survivors of RANK_TIMEOUT_S are killed, and any
    non-zero exit or timeout raises."""
    from concurrent.futures import ThreadPoolExecutor, wait

    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in commands]
    try:
        with ThreadPoolExecutor(len(procs)) as pool:
            futures = [pool.submit(p.communicate, timeout=RANK_TIMEOUT_S) for p in procs]
            wait(futures)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    outputs = [f.result()[0] if f.exception() is None else "timed out" for f in futures]
    for i, (p, text) in enumerate(zip(procs, outputs)):
        if p.returncode != 0 or text == "timed out":
            raise AssertionError(f"process {i} of {len(procs)} failed ({p.returncode}):\n{text[-4000:]}")
    return wall, outputs


def largest_differences(ours: dict, ref: dict) -> dict:
    """Largest absolute difference of each metric (NaN where both are)."""
    import numpy as np

    out = {}
    for key in ref:
        a, b = np.asarray(ours[key], np.float64), np.asarray(ref[key], np.float64)
        both = np.isnan(a) & np.isnan(b)
        out[key] = float(np.max(np.where(both, 0.0, np.abs(a - b)), initial=0.0))
    return out


def multi_device_phase(torch, root: Path, dev, counters, launches_by_path: dict, single_json: dict) -> dict:
    """Phase 11: (a) the pipelined engine on a mesh of two shards on one
    card against the single-device run and against the mesh run with the
    plain versions; (b) a two-rank `bundle --multi-host` job through the
    CLI entry, both ranks on the card, against the single-process run."""
    import os

    import numpy as np

    from audio_analysis_tpu_torch.engine import EngineConfig, analyze_bundle_pipelined, graphs, make_mesh
    from audio_analysis_tpu_torch.engine.mesh import bundle_aggregates
    from audio_analysis_tpu_torch.io import open_bundle_chunks_i16

    out = {"card": card_line()}
    _meta, lengths, names, n_max, loader = open_bundle_chunks_i16(root)
    cfg = EngineConfig()
    mesh = make_mesh(devices=[dev, dev])

    def run(run_mesh):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = analyze_bundle_pipelined(loader, lengths, n_max, cfg, CHUNK_TAPS, mesh=run_mesh, device=dev)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, res

    # 11 (a): 16 taps, 8 a shard: one chunk, each shard the 8-tap batch of
    # a single-device chunk, so K1 and K2 launch twice a shard, and both
    # shards replay the graph of the single-device chunk's key
    _s, single = run(None)
    torch.cuda.reset_peak_memory_stats(dev)
    ((cold, sharded), launches), mesh_graphs = graph_runs(lambda: count_launches(counters, lambda: run(mesh)))
    if (launches["edc"], launches["stft"]) != (4, 4):
        raise AssertionError(f"mesh of 2 shards: launches {launches}, expected K1 4, K2 4")
    if mesh_graphs["replays"] != 2 or mesh_graphs["captures"]:
        raise AssertionError(f"mesh of 2 shards: graphs {mesh_graphs}, expected a replay a shard")
    launches_by_path["multi_device"] = launches
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    warm = [run(mesh)[0] for _ in range(3)]
    single_warm = [run(None)[0] for _ in range(3)]
    with graphs.eager():
        eager_s, eager_mesh = run(mesh)
    differing = [k for k in eager_mesh if not np.array_equal(sharded[k], eager_mesh[k], equal_nan=True)]
    if differing:
        raise AssertionError(f"mesh: the graph run differs from the eager() run in {differing}")
    with plain_versions():
        plain_s, plain = run(mesh)
    # as bundle_metrics.json holds them: floats as float64, under its limits
    compare_metrics(*(json.loads(json.dumps({k: v.tolist() for k, v in r.items()})) for r in (sharded, single)))
    compare_metrics(*(json.loads(json.dumps({k: v.tolist() for k, v in r.items()})) for r in (sharded, plain)))
    diff = largest_differences(sharded, single)
    out["mesh"] = {
        "devices": [str(d) for d in mesh], "cold_s": cold, "warm_s": warm, "single_device_warm_s": single_warm,
        "eager_s": eager_s, "plain_s": plain_s, "peak_device_memory_gib": peak, "launches": launches,
        "graphs": mesh_graphs, "bit_equal_to_eager": True,
        "max_abs_diff_vs_single_device": max(diff.values()),
        "keys_differing_from_single_device": {k: v for k, v in diff.items() if v > 0.0},
        "max_abs_diff_vs_plain": max(largest_differences(sharded, plain).values()),
    }
    log(f"multi_device (a) mesh {out['mesh']['devices']}: cold {cold:.3f} s, warm {min(warm):.3f}-{max(warm):.3f} s "
        f"(single device {min(single_warm):.3f}-{max(single_warm):.3f} s), peak {peak:.3f} GiB, launches {launches}; "
        f"largest difference from the single-device run {out['mesh']['max_abs_diff_vs_single_device']:.3g}, "
        f"graphs {mesh_graphs}, bit-equal to the eager() run, kernel run == plain run")

    # 11 (b): the two-rank job, both ranks on the card, against a
    # single-process `bundle --no-plots` job and phase 4's single-process run
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", PYTHONPATH=str(REPO))
    single_wall, _ = run_processes([[sys.executable, "-m", "audio_analysis_tpu_torch.cli", "bundle", "--input",
                                     str(root), "--no-plots", "--reports-subdir", "reports_single_job"]], env)
    work = REPO / "build" / "chip_smoke_multi_device"
    work.mkdir(parents=True, exist_ok=True)
    rank_json = [work / f"rank{i}.json" for i in range(RANKS)]
    addresses = [free_address() for _ in range(3)]
    commands = [
        [sys.executable, "-c", RANK_CODE, str(REPO), str(rank_json[i]), "bundle", "--input", str(root),
         "--multi-host", "--num-processes", str(RANKS), "--process-id", str(i), "--reports-subdir", "reports_mh",
         *addresses]
        for i in range(RANKS)
    ]
    job_wall, logs = run_processes(commands, env)
    ranks = [json.loads(p.read_text()) for p in rank_json]
    total = dict.fromkeys(KERNELS, 0)
    for i, r in enumerate(ranks):
        if r["banned_modules"]:
            raise AssertionError(f"rank {i} loaded {r['banned_modules']}")
        for one in r["runs"]:
            if one["launches"] != {"edc": 2, "stft": 2, "karplus": 0, "pool": 0, "dbfit": 2}:
                raise AssertionError(f"rank {i}: launches {one['launches']}, expected K1 2, K2 2, K3 0, K4 0, K5 2")
        # a rank's one chunk: eager in its cold run (no call ahead), captured
        # in its first warm run (the key ended a call), replayed in the second
        if [(one["graphs"]["captures"], one["graphs"]["replays"]) for one in r["runs"]] != [(0, 0), (1, 0), (0, 1)]:
            raise AssertionError(f"rank {i}: graphs {[one['graphs'] for one in r['runs']]}")
        total = {k: total[k] + r["runs"][0]["launches"][k] for k in total}
    launches_by_path["multi_device --multi-host (2 ranks)"] = total
    if ["Wrote bundle report index:" in log for log in logs] != [True, False]:
        raise AssertionError("the index line must come from rank 0 alone")
    reports = root / "reports_mh"
    mh_json = json.loads((reports / "bundle_metrics.json").read_text())
    if list(mh_json) != ["taps", "channels", "metrics"] or mh_json["taps"] != names:
        raise AssertionError(f"multi-host bundle_metrics.json: keys {list(mh_json)}")
    compare_metrics(mh_json["metrics"], single_json["metrics"])
    for i, tap in enumerate(names):
        ours = (reports / tap / f"{tap}_report.md").read_text()
        if f"**Analysed by process:** {i // (TAPS // RANKS)}" not in ours:
            raise AssertionError(f"{tap}: not analysed by its owner")
        single_md = (root / "reports_cuda" / tap / f"{tap}_report.md").read_text()
        compare_markdown(ours.split("---\n\n", 1)[1], single_md.split("---\n\n", 1)[1], tap)
    index = (reports / "bundle_report.md").read_text()
    m = single_json["metrics"]
    expected = bundle_aggregates(m["t30_rt60"], m["t30_ok"], m["early10_time"], m["early10_ok"])
    t30 = np.asarray(m["t30_rt60"])[np.asarray(m["t30_ok"], bool)]
    early = np.asarray(m["early10_time"])[np.asarray(m["early10_ok"], bool)]
    for key, numpy_value in (("bundle_median_t30", np.median(t30)), ("bundle_mean_early10", np.mean(early))):
        printed = float(re.search(rf"\*\*{key}:\*\* (\S+) s", index).group(1))
        if abs(printed - numpy_value) > 1e-3 * abs(numpy_value) + 1e-4 or abs(printed - expected[key]) > 1e-4:
            raise AssertionError(f"{key}: index {printed}, numpy {numpy_value}")
    if f"**bundle_valid_taps:** {int(expected['bundle_valid_taps'])}" not in index:
        raise AssertionError("bundle_valid_taps differs from the single-process run")
    out["multi_host"] = {
        "ranks": RANKS, "job_wall_s": job_wall, "single_process_job_wall_s": single_wall,
        "rank_runs": [r["runs"] for r in ranks], "rank_devices": [r["device"] for r in ranks],
        "launches": total,
    }
    log(f"multi_device (b) {RANKS} ranks on {[r['device'] for r in ranks]}: job {job_wall:.2f} s (three runs a "
        f"rank), single-process job {single_wall:.2f} s; per rank cold/capture/replay "
        f"{[[round(x['wall_s'], 3) for x in r['runs']] for r in ranks]} s, engine "
        f"{[[round(x['engine_s'], 3) for x in r['runs']] for r in ranks]} s, gathered "
        f"{sum(r['runs'][0]['gather_bytes_sent'] for r in ranks)} bytes (sent by the ranks {[r['runs'][0]['gather_bytes_sent'] for r in ranks]}); "
        "markdown, metrics and aggregates agree")
    return out


# ---------------------------------------------------------------- fuzz ----

FUZZ_SEED = 10
K2_INSTANCES = (256, 512, 1024, 2048, 4096, 8192, 16384)
FUZZ_K1_DRAWS = 24
FUZZ_K2_EXTRA_DRAWS = 5
FUZZ_ENGINE_DRAWS = 5
FUZZ_TAPS = 8
# K1 against the float64 oracle: tests/test_edc_precision.py's 0.02 dB
# wherever the oracle's curve is at or above -80 dB; K2 against the
# oracle's magnitude, and K2 against its plain version: 1e-5 of the
# reference's largest value (phase 2)
EDC_DB_TOL = 0.02
STFT_REL_TOL = 1e-5
# fuzz finding (repaired): a fit's time axis is index x float32(1/rate), as
# XLA computes the JAX package's index / rate (a 9-point band EDT fit at
# t = 0.66 s moved by 1.2e-4 relative); tests/test_torch_fuzz_engine.py
# TIME_AXIS_DRAW, on the bundle
TIME_AXIS_FIELDS = {
    "trim_to_peak": False, "ignore_leading_seconds": 0.02, "edc_epsilon": 1e-12,
    "t20_range_db": (-1.9, -22.75), "t30_range_db": (-2.6, -41.64), "edt_range_db": (-1.9, -6.9),
    "band_mode": "third", "band_f_min_hz": 125.0, "band_f_max_hz": 8000.0, "transition_width_octaves": 0.5,
    "f_min_hz": 100.0, "f_max_hz": 8000.0, "n_fft": 2048, "hop_length": 57, "modal_n_fft": 2048,
    "run_group_delay": False, "run_stft": False, "run_modal": False,
}

# fuzz finding (repaired): the frame blocks ran a chunk's taps in one plane
# (the JAX engine maps them per tap); n_fft 200, hop 25, modal_n_fft 12000
# asked for 29.7 GiB. Now split by taps past the engine's budget: here the
# modal cloud's 4.2 GB a tap runs one tap a group, 8 K2 launches
FRAME_PLANE_FIELDS = {"hop_length": 32, "modal_n_fft": 16384, "run_bands": False, "run_stft": False}


def fuzz_log(check: str, i: int, seed: int, draw) -> None:
    """The draw, printed before it runs: a failure raises right after it."""
    log(f"fuzz {check} draw {i} (seed {seed}): {draw}")


def fuzz_k1(torch, edc, oracle, dev, rng, seed: int) -> dict:
    """K1 at drawn shapes and settings against its plain version on the card
    (phase 2's rules) and, on one or two rows, against the float64 oracle."""
    import numpy as np

    from audio_analysis_tpu_torch import _build

    tile = _build.library().aa_edc_tile_size()
    sizes = [1, 2, 3, 100, tile - 1, tile + 1, 3 * tile + 5, (1 << 16) - 3, (1 << 18) + 7, N - 3 * 4096 + 1, N]
    worst_plain = worst_oracle = 0.0
    for i in range(FUZZ_K1_DRAWS):
        n = sizes[i] if i < len(sizes) else int(rng.choice(sizes))
        rows = int(rng.integers(1, 65)) if n < N else int(rng.integers(1, 17))
        lengths = rng.integers(0, n + 1, rows)
        lengths[: min(rows, 3)] = [n, 0, 1][: min(rows, 3)]
        eps = float(rng.choice([1e-30, 1e-20, 1e-12, 1e-6]))
        floor = float(rng.choice([-120.0, -90.0, -60.0, -math.inf]))
        fuzz_log("k1", i, seed, {"rows": rows, "n": n, "lengths": lengths[:6].tolist(), "eps": eps, "floor_db": floor})
        g = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
        tau = 5.0 + 4.0 * n * torch.rand(rows, 1, generator=g, device=dev)
        t = torch.arange(n, device=dev, dtype=torch.float32)
        lens = torch.from_numpy(lengths.astype(np.int32)).to(dev)
        x = torch.randn(rows, n, generator=g, device=dev) * torch.exp(-t / tau)
        x = torch.where(t[None, :] < lens[:, None], x, 0.0)
        got = edc.schroeder_edc_db_cuda(x, lens, eps, floor)
        ref = edc.schroeder_edc_db_plain(x, lens, eps, floor)
        past = t[None, :] >= lens[:, None]
        if not (bool((got[past] == 0).all()) and bool((got[lens > 0, 0] == 0).all())):
            raise AssertionError(f"K1 fuzz draw {i}: not 0 past length or not 0 dB at index 0")
        usable = (ref > -100.0) & ~past
        err = (got - ref).abs()[usable].max().item() if bool(usable.any()) else 0.0
        if not err <= EDC_DB_TOL:
            raise AssertionError(f"K1 fuzz draw {i}: {err} dB from the plain version")
        worst_plain = max(worst_plain, err / EDC_DB_TOL)
        for row in [r for r in range(rows) if lengths[r] >= 4][:2]:
            length = int(lengths[row])
            _, ref64, _ = oracle.schroeder_edc_db(x[row, :length].double().cpu().numpy(), SR, False, 0.0, eps, floor)
            region = ref64 >= -80.0
            err64 = float(np.abs(got[row, :length].cpu().numpy()[region] - ref64[region]).max()) if region.any() else 0.0
            if not err64 <= EDC_DB_TOL:
                raise AssertionError(f"K1 fuzz draw {i} row {row}: {err64} dB from the float64 oracle")
            worst_oracle = max(worst_oracle, err64 / EDC_DB_TOL)
    return {"draws": FUZZ_K1_DRAWS, "worst_ratio_vs_plain": worst_plain, "worst_ratio_vs_oracle": worst_oracle}


def fuzz_k2(torch, stft, oracle, dev, rng, seed: int) -> dict:
    """K2 at every instance n_fft and more drawn ones, with drawn hops,
    k_out, floor, window and ragged lengths, against its plain version on
    the card and, on one row, against the float64 oracle's magnitude; one
    draw has no frame (N < n_fft). The dispatching wrapper at n_fft outside
    K2's range launches nothing."""
    import numpy as np

    sizes = list(K2_INSTANCES) + [int(rng.choice(K2_INSTANCES)) for _ in range(FUZZ_K2_EXTRA_DRAWS)]
    instances = set()
    worst_plain = worst_oracle = 0.0
    for i, n_fft in enumerate(sizes):
        hop = n_fft // int(rng.choice([1, 2, 4, 8])) if rng.random() < 0.5 else int(rng.integers(n_fft // 8, n_fft + 1))
        n = n_fft - 1 if i == len(K2_INSTANCES) else n_fft + int(rng.integers(0, 200)) * hop + int(rng.integers(0, hop))
        rows = int(rng.integers(1, 17))
        lengths = rng.integers(0, n + 1, rows)
        lengths[: min(rows, 5)] = [n, 0, 1, n_fft - 1, min(n, n_fft)][: min(rows, 5)]
        f_bins = n_fft // 2 + 1
        k_out = [None, f_bins, int(rng.integers(1, f_bins + 1))][int(rng.integers(3))]
        floor_db = float(rng.choice([-200.0, -120.0, -60.0]))
        hann = bool(rng.random() < 0.7)
        fuzz_log("k2", i, seed, {"n_fft": n_fft, "hop": hop, "n": n, "rows": rows, "lengths": lengths[:6].tolist(),
                                 "k_out": k_out, "floor_db": floor_db, "hann": hann})
        g = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
        t = torch.arange(n, device=dev, dtype=torch.float32)
        lens = torch.from_numpy(lengths.astype(np.int32)).to(dev)
        x = torch.randn(rows, n, generator=g, device=dev) * torch.exp(-t / (0.5 * n + 1.0))
        x = torch.where(t[None, :] < lens[:, None], x, 0.0)
        floor_lin = 10.0 ** (floor_db / 20.0)
        before = stft.STFT_KERNEL.launches
        got = stft.stft_magnitude_cuda(x, lens, n_fft, hop, hann, floor_lin, k_out)
        if stft.STFT_KERNEL.launches > before:
            instances.add(n_fft)
        ref = stft.stft_magnitude_plain(x, lens, n_fft, hop, hann, floor_lin, k_out)
        if got.shape != ref.shape:
            raise AssertionError(f"K2 fuzz draw {i}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
        if ref.numel():
            rel = (got - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
            if not rel < STFT_REL_TOL:
                raise AssertionError(f"K2 fuzz draw {i}: {rel} of the plain version's largest value")
            worst_plain = max(worst_plain, rel / STFT_REL_TOL)
        valid = [stft.num_frames_static(int(length), n_fft, hop) for length in lengths]
        row = int(np.argmax(valid))
        if valid[row]:
            length = int(lengths[row])
            _, _, ref_db = oracle.stft_magnitude_db(x[row, :length].double().cpu().numpy(), SR, n_fft, hop, hann, floor_db)
            k = f_bins if k_out is None else k_out
            ref64 = 10.0 ** (ref_db[:k].T / 20.0)
            rel = float(np.abs(got[row, : valid[row]].cpu().numpy() - ref64).max() / ref64.max())
            if not rel < STFT_REL_TOL:
                raise AssertionError(f"K2 fuzz draw {i} row {row}: {rel} of the oracle's largest value")
            worst_oracle = max(worst_oracle, rel / STFT_REL_TOL)
    if instances != set(K2_INSTANCES):
        raise AssertionError(f"K2 instances launched {sorted(instances)}, expected {list(K2_INSTANCES)}")
    outside = {}
    for n_fft in (128, 3000, 20000):
        x = torch.randn(2, 3 * n_fft, device=dev)
        lens = torch.tensor([3 * n_fft, 2 * n_fft], dtype=torch.int32, device=dev)
        before = stft.STFT_KERNEL.launches
        got = stft.stft_magnitude(x, lens, n_fft, 333).mag
        outside[n_fft] = stft.STFT_KERNEL.launches - before
        if outside[n_fft] or not torch.equal(got, stft.stft_magnitude_plain(x, lens, n_fft, 333)):
            raise AssertionError(f"K2 at n_fft {n_fft}: {outside[n_fft]} launches, or not the plain version")
    return {"draws": len(sizes), "worst_ratio_vs_plain": worst_plain, "worst_ratio_vs_oracle": worst_oracle,
            "instances": sorted(instances), "launches_outside_range": outside}


def draw_engine_fields(rng) -> dict:
    """An EngineConfig's fields over tests/test_torch_fuzz_engine.py's
    space (n_fft up to 16384 on the 2^20-sample bundle)."""
    def pick(*values):
        return values[int(rng.integers(len(values)))]

    def n_fft():
        return pick(*K2_INSTANCES) if rng.random() < 0.6 else pick(128, 200, 1000, 3000, 5000, 12000)

    def db_range(high, span):
        hi = round(float(rng.uniform(*high)), 2)
        return (hi, round(hi - float(rng.uniform(*span)), 2))

    size = n_fft()
    hop = size // pick(1, 2, 4, 8) if rng.random() < 0.5 else int(rng.integers(16, size + 1))
    fields = {
        "sample_rate_hz": pick(48_000, 44_100), "trim_to_peak": bool(rng.random() < 0.5),
        "ignore_leading_seconds": pick(0.0, 0.001, 0.01, 0.02), "edc_floor_db": pick(-150.0, -120.0, -90.0, -70.0),
        "edc_epsilon": pick(1e-30, 1e-20, 1e-12), "fit_lower_limit_db": pick(-95.0, -80.0, -60.0, -50.0),
        "t20_range_db": db_range((-10.0, 0.0), (10.0, 30.0)), "t30_range_db": db_range((-10.0, -2.0), (20.0, 40.0)),
        "edt_range_db": db_range((-2.0, 0.0), (5.0, 15.0)), "band_mode": pick("three", "octave", "third"),
        "low_upper_hz": pick(150.0, 250.0, 400.0), "mid_center_hz": pick(700.0, 1000.0, 1500.0),
        "mid_width_octaves": pick(1.0, 2.0, 3.0), "high_lower_hz": pick(2500.0, 4000.0, 6000.0),
        "band_f_min_hz": pick(31.5, 63.0, 125.0), "band_f_max_hz": pick(4000.0, 8000.0, 16000.0),
        "transition_width_octaves": pick(1 / 12, 1 / 6, 0.5, 1.0), "bands_decimate": bool(rng.random() < 0.5),
        "f_min_hz": pick(10.0, 20.0, 100.0), "f_max_hz": pick(8000.0, 20000.0, 30000.0),
        "magnitude_floor_db": pick(-140.0, -120.0, -100.0), "n_fft": size, "hop_length": hop,
        "modal_n_fft": n_fft(), "modal_log_bins_per_octave": pick(6, 12, 24, 48), "modal_min_bins": pick(4, 24, 64),
        "modal_min_fit_points": pick(4, 10, 16), "modal_min_peak_db_above_floor": pick(0.0, 20.0, 40.0),
        "modal_trim_bins": bool(rng.random() < 0.5), "diffusion_window_seconds": pick(0.01, 0.02, 0.05),
        "diffusion_hop_seconds": pick(0.005, 0.013, 0.05), "diffusion_max_lag_ms": pick(0.5, 1.5, 5.0),
        "echo_density_threshold_rms": pick(0.5, 1.0, 2.0), "downmix_to_mono": bool(rng.random() < 0.5),
    }
    fields.update({f"run_{b}": bool(rng.random() < 0.7) for b in ("bands", "fr", "group_delay", "stft", "modal", "diffusion")})
    return fields


def expected_engine_launches(cfg, taps: int, n: int) -> tuple:
    """(K1, K2) launches of one chunk of `taps` taps: the broadband EDC,
    then with the bands one EDC per decimation group (one group at full
    rate), per tap in octave and third-octave mode; K2 for the shared STFT
    and for the modal cloud where K2 has the block's n_fft, once per tap
    group: as many taps a group as keep the block's complex frame plane
    within the engine's FRAME_PLANE_BUDGET_BYTES."""
    from audio_analysis_tpu_torch.engine.batch import FRAME_PLANE_BUDGET_BYTES, band_masks
    from audio_analysis_tpu_torch.ops import fftmask, stft

    k1 = 1
    if cfg.run_bands:
        masks = band_masks(cfg, n)
        factors = fftmask.band_decimation_factors(masks, n) if cfg.bands_decimate else (1,)
        groups = len(set(factors)) if max(factors) > 1 else 1
        k1 += groups * (taps if masks.shape[0] > 3 else 1)
    channels = 1 if cfg.downmix_to_mono else 2
    k2 = 0
    for on, n_fft in ((cfg.run_stft, cfg.n_fft), (cfg.run_modal, cfg.modal_n_fft)):
        if on and stft.kernel_takes(n_fft):
            plane = channels * (1 + (n - n_fft) // cfg.hop_length) * (n_fft + 2) * 4
            k2 += -(-taps // max(1, FRAME_PLANE_BUDGET_BYTES // plane))
    return k1, k2


def phase5_tolerance(key: str) -> tuple:
    """Phase 5's JSON limits (compare_metrics): floats 1e-4 relative and
    absolute, per-bin modal fits 1e-2, group delay 1e-3 relative."""
    return {"gd_p10": (1e-3, 1e-4), "gd_median": (1e-3, 1e-4), "gd_p90": (1e-3, 1e-4)}.get(key, (1e-4, 1e-4))


def fuzz_engine(torch, root: Path, dev, counters, rng, seed: int) -> dict:
    """Drawn EngineConfigs (and the fixed draws of the fuzz findings)
    through `analyze_bundle_pipelined` on the bundle's first 8 taps, kernels
    against plain versions under phase 5's limits with tests/_engine_parity.py's
    conditioning runs (the kernel path on the taps with float32 round-off
    noise and with the dB targets moved), K1 / K2 launches exactly as the
    config implies."""
    import dataclasses

    import numpy as np

    sys.path.insert(0, str(REPO / "tests"))
    from _engine_parity import assert_engines_agree, conditioning_runs

    from audio_analysis_tpu_torch.engine import EngineConfig, analyze_batch, analyze_bundle_pipelined, graphs
    from audio_analysis_tpu_torch.io import open_bundle_chunks_i16

    _meta, lengths, _names, n_max, loader = open_bundle_chunks_i16(root)
    lengths = lengths[:FUZZ_TAPS]
    x = loader(0, FUZZ_TAPS).astype(np.float32) * (1.0 / 32768.0)

    def on_card(xs, lens, cfg):
        res = analyze_batch(torch.from_numpy(xs).to(dev), torch.from_numpy(lens).to(dev), cfg)
        return {k: v.cpu().numpy() for k, v in res.items()}

    draws = [("time_axis_finding", {**dataclasses.asdict(EngineConfig()), **TIME_AXIS_FIELDS}),
             ("frame_plane_finding", {**dataclasses.asdict(EngineConfig()), **FRAME_PLANE_FIELDS})]
    draws += [(f"drawn {i}", draw_engine_fields(rng)) for i in range(FUZZ_ENGINE_DRAWS)]
    worst, totals, replays, peaks = 0.0, dict.fromkeys(KERNELS, 0), 0, []
    for i, (label, fields) in enumerate(draws):
        cfg = EngineConfig(**fields)
        fuzz_log("engine", i, seed, {"label": label, **fields})
        def run():
            return analyze_bundle_pipelined(loader, lengths, n_max, cfg, FUZZ_TAPS, device=dev)

        torch.cuda.reset_peak_memory_stats(dev)
        (kernel, launches), cold_graphs = graph_runs(lambda: read_launches(counters, run))
        peaks.append((torch.cuda.max_memory_allocated(dev), label, cfg))
        want = expected_engine_launches(cfg, FUZZ_TAPS, n_max)
        if (launches["edc"], launches["stft"], launches["dbfit"]) != (*want, want[0]):
            raise AssertionError(f"engine fuzz draw {i}: launches {launches}, expected K1 {want[0]}, K2 {want[1]}, "
                                 f"K5 {want[0]}")
        for name in totals:
            totals[name] += launches[name]
        # the draw's one chunk: eager, then captured (the key ended a call),
        # then replayed, each with the same launches; the replay against
        # the eager() kernel run: bit-equal
        (_, capture_launches), capture_graphs = graph_runs(lambda: read_launches(counters, run))
        (replayed, replay_launches), warm_graphs = graph_runs(lambda: read_launches(counters, run))
        ran = [(g["captures"], g["replays"]) for g in (cold_graphs, capture_graphs, warm_graphs)]
        if ran != [(0, 0), (1, 0), (0, 1)] or not capture_launches == replay_launches == launches:
            raise AssertionError(f"engine fuzz draw {i}: (captures, replays) {ran}, launches {launches}, "
                                 f"{capture_launches}, {replay_launches}")
        with graphs.eager():
            eager_run = run()
        differing = [k for k in eager_run if not np.array_equal(replayed[k], eager_run[k], equal_nan=True)]
        if differing:
            raise AssertionError(f"engine fuzz draw {i}: the graph run differs from the eager() run in {differing}")
        replays += 1
        with plain_versions():
            plain = run()
        runs = conditioning_runs(on_card, x, lengths, cfg)
        worst = max(worst, assert_engines_agree(plain, kernel, runs, phase5_tolerance, np.ones(FUZZ_TAPS, bool),
                                                f"engine fuzz draw {i}: "))
    live = live_graphs_memory(torch, dev, [cfg for _peak, _label, cfg in sorted(peaks, key=lambda p: -p[0])],
                              lambda cfg: analyze_bundle_pipelined(loader, lengths, n_max, cfg, FUZZ_TAPS, device=dev))
    live["draws"] = [label for _peak, label, _cfg in sorted(peaks, key=lambda p: -p[0])[:graphs.MAX_GRAPHS]]
    # fuzz finding (repaired): a frame block longer than the signal raises a
    # ValueError before any launch, as the JAX engine raises one
    for j, block in enumerate(("n_fft", "modal_n_fft")):
        cfg = EngineConfig(**{block: 2 * n_max})
        fuzz_log("engine", len(draws) + j, seed, {"label": "frame_longer_than_signal", block: 2 * n_max})
        for counter in counters:
            counter.launches = 0
        try:
            analyze_bundle_pipelined(loader, lengths, n_max, cfg, FUZZ_TAPS, device=dev)
        except ValueError as exc:
            if block not in str(exc) or any(c.launches for c in counters):
                raise AssertionError(f"{block} above N: {exc}; launches {[c.launches for c in counters]}") from exc
        else:
            raise AssertionError(f"{block} above N ran; the JAX engine raises a ValueError")
    return {"draws": len(draws) + 2, "worst_ratio_vs_plain": worst, "launches": totals,
            "graph_runs_bit_equal_to_eager": replays, "live_graphs_memory": live}


def live_graphs_memory(torch, dev, configs, run) -> dict:
    """Device memory with MAX_GRAPHS graphs live: the first MAX_GRAPHS of
    `configs` (the drawn configs by their eager peak, largest first), each
    key already seen, run once through the graphs (each captured into the
    device's shared pool), beside the same runs under eager() and through
    a cache whose every capture starts a pool of its own (`private_pools`,
    one pool a graph, for comparison); the allocator's cache returned to
    the device before each set."""
    from audio_analysis_tpu_torch.engine import graphs

    picked = configs[:graphs.MAX_GRAPHS]
    out = {}
    for label in ("eager", "graphs", "private_pools"):
        graphs.STEP_GRAPHS.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        cache = graphs.StepGraphs() if label == "private_pools" else graphs.STEP_GRAPHS
        cache._seen.update(graphs.STEP_GRAPHS._seen)
        with contextlib.ExitStack() as stack:
            if label == "eager":
                stack.enter_context(graphs.eager())
            stack.enter_context(mock.patch.object(graphs, "STEP_GRAPHS", cache))
            before = cache.stats()
            for cfg in picked:
                if label == "private_pools":
                    cache._pools.clear()  # the next capture starts a pool of its own
                run(cfg)
            after = cache.stats()
            pools = graph_pool_gib(torch, dev)
        out[label] = {"graphs_live": len(cache.keys()),
                      "captures": after["captures"] - before["captures"],
                      "memory_returns": after["memory_returns"] - before["memory_returns"],
                      "graph_pools_gib": pools["live"] + pools["unused"],
                      "reserved_gib": torch.cuda.memory_reserved(dev) / 2**30,
                      "peak_allocated_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                      "peak_reserved_gib": torch.cuda.max_memory_reserved(dev) / 2**30}
        if label == "private_pools":
            cache.clear()
    for label in ("graphs", "private_pools"):
        if out[label]["captures"] != len(picked) or out[label]["graphs_live"] != len(picked):
            raise AssertionError(f"live graphs: {out[label]}, expected {len(picked)} captured and live")
    graphs.STEP_GRAPHS.clear()
    log("memory with the drawn configs' graphs live: " + json.dumps(out))
    return out


def summary_ratio(ref: str, got: str, rel: float, abs_: float) -> float:
    """The largest ratio of a summary number's difference to its limit."""
    from _summary_parity import _ANY_NUM

    ratios = [abs(float(a) - float(b)) / max(abs_, rel * max(abs(float(a)), abs(float(b))))
              for a, b in zip(_ANY_NUM.findall(ref), _ANY_NUM.findall(got))]
    return max(ratios, default=0.0)


def draw_per_file_argv(rng, cmd: str) -> list:
    """Drawn flags of one per-file command (K1's and K2's analyses)."""
    def pick(*values):
        return values[int(rng.integers(len(values)))]

    argv = [cmd]
    if rng.random() < 0.3:
        argv.append("--mono")
    if cmd == "decay":
        argv += ["--ignore-leading", str(pick(0.0, 0.002, 0.01)), "--edc_floor_db", str(pick(-150.0, -120.0, -90.0)),
                 "--fit_lower_limit_db", str(pick(-80.0, -60.0)), "--smoothing", str(pick(0, 9, 480)),
                 pick("--compute_edt", "--no-compute_edt"), pick("--trim_to_peak", "--no-trim_to_peak")]
    elif cmd == "rt60bands":
        argv += ["--band_mode", pick("three", "octave", "third"), "--low_upper_hz", str(pick(200.0, 300.0)),
                 "--high_lower_hz", str(pick(3000.0, 4000.0)), "--transition_width_octaves", str(pick(1 / 6, 0.5)),
                 "--f_min_hz", str(pick(31.5, 125.0)), "--f_max_hz", str(pick(8000.0, 16000.0))]
        argv += [flag for flag in ("--include_t20", "--include_edt") if rng.random() < 0.5]
    else:
        n_fft = pick(*K2_INSTANCES) if rng.random() < 0.7 else pick(128, 3000, 20000)
        argv += ["--n_fft", str(n_fft), "--hop_length", str(pick(256, 333, 512, 1024)),
                 "--floor_db", str(pick(-120.0, -100.0)), "--ignore-leading", str(pick(0.0, 0.01))]
        if rng.random() < 0.3:
            argv.append("--no_hann_window")
        if cmd == "waterfall":
            argv += ["--slice_mode", pick("auto", "uniform_time", "uniform_frames"),
                     "--db_reference", pick("global_max", "slice_max"), "--num_slices", str(pick(6, 18))]
        elif cmd == "modalcloud":
            argv += ["--metric", pick("t30", "t20", "edt"), "--min_fit_points", str(pick(8, 10)),
                     "--log_bins_per_octave", str(pick(12, 24))]
        else:
            argv += ["--dynamic_range_db", str(pick(60.0, 90.0))]
    return argv


def fuzz_per_file(torch, cli_main, root: Path, counters, rng, seed: int) -> dict:
    """Drawn flag sets of decay, rt60bands, spectrogram, waterfall and
    modalcloud through the CLI entry on the bundle's first tap: the kernel
    run against the plain run (phase 8's summary tolerances, the same JSON
    keys), K1 / K2 launches exact (decay and rt60bands K1 once; the STFT
    analyses K2 once where it has the n_fft, else 0)."""
    sys.path.insert(0, str(REPO / "tests"))
    from _summary_parity import assert_summaries_agree, json_skeleton

    from audio_analysis_tpu_torch.ops import stft

    out_dir = REPO / "build" / "chip_smoke_fuzz"
    out_dir.mkdir(parents=True, exist_ok=True)
    tap = root / "taps" / "tap00.wav"
    commands = ["decay", "rt60bands", "spectrogram", "waterfall", "modalcloud"] * 2
    worst, totals = 0.0, dict.fromkeys(KERNELS, 0)
    for i, cmd in enumerate(commands):
        argv = draw_per_file_argv(rng, cmd)
        fuzz_log("per_file", i, seed, " ".join(argv))
        if cmd in ("decay", "rt60bands"):
            want = (1, 0)
        else:
            want = (0, int(stft.kernel_takes(int(argv[argv.index("--n_fft") + 1]))))

        def run(name):
            return run_cli_text(torch, cli_main, [*argv, "--input", str(tap), "--no_show",
                                                  "--json", str(out_dir / f"{i}_{name}.json")])[1]

        kernel_text, launches = read_launches(counters, lambda: run("kernel"))
        if (launches["edc"], launches["stft"], launches["dbfit"]) != (*want, 0):
            raise AssertionError(f"per-file fuzz draw {i}: launches {launches}, expected K1 {want[0]}, K2 {want[1]}, "
                                 "K5 0")
        for name in totals:
            totals[name] += launches[name]
        with plain_versions():
            plain_text = run("plain")
        tol = SUMMARY_TOLERANCES[cmd]
        ref, got = plain_text.split("\n", 1)[1], kernel_text.split("\n", 1)[1]
        assert_summaries_agree(ref, got, *tol, f"per-file fuzz draw {i}")
        worst = max(worst, summary_ratio(ref, got, *tol))
        if json_skeleton(json.loads((out_dir / f"{i}_kernel.json").read_text())) != json_skeleton(
                json.loads((out_dir / f"{i}_plain.json").read_text())):
            raise AssertionError(f"per-file fuzz draw {i}: JSON keys of the kernel and the plain run differ")
    return {"draws": len(commands), "worst_ratio_vs_plain": worst, "launches": totals}


# the rest draws (filter, zplane, deconvolve, ir) and the gen draws; the
# gen flag space and the deconvolution limits are tests/_fuzz_spaces.py's
FUZZ_REST_COMMANDS = ("filter", "zplane", "deconvolve", "ir") * 2 + ("filter", "zplane")
FUZZ_GEN_DRAWS = 4
FUZZ_MESH_DRAWS = 2
# every module phase 12's draws load
FUZZ_MODULES = ("oracle", "analyses.filterplot", "analyses.zplane", "analyses.deconvolve",
                "analyses.impulse_response", "cli.gen_cli", "signals.torchgen", "engine.mesh")


def draw_rest_argv(rng, cmd: str, inputs: dict) -> tuple:
    """(argv without --json / --device, input label) of one drawn filter,
    zplane, deconvolve or ir run (tests/test_torch_fuzz_rest.py's and
    tests/test_torch_fuzz.py's spaces)."""
    def pick(*values):
        return values[int(rng.integers(len(values)))]

    if cmd == "deconvolve":
        reg = pick(1e-12, 1e-10, 1e-8)
        label = pick(*[k for k in inputs if k.startswith("recorded")])
        return ["deconvolve", "--recorded_wav_file_path", str(inputs[label]), "--sweep_wav_file_path",
                str(inputs["sweep"]), "--regularization_relative", str(reg),
                pick("--normalise_peak", "--no-normalise_peak"), "--target_peak", str(pick(0.5, 0.95, 1.0)),
                pick("--remove_dc", "--no-remove_dc"), "--output_length_mode", pick("recorded", "full_fft")], label
    if cmd == "ir":
        argv = ["ir", "--no_show", "--early-window", str(pick(0.005, 0.08, 0.5)),
                "--floor-db", str(pick(-140.0, -120.0, -60.0))]
        return argv + (["--mono"] if rng.random() < 0.3 else []), pick("tap", "verb", "damped")
    argv = [cmd, "--no-show" if cmd == "zplane" else "--no_show"]
    if rng.random() < 0.3:
        argv.append("--mono")
    argv += ["--ignore-leading", str(pick(0.0, 0.002, 0.01))]
    if cmd == "zplane":
        duration = pick(None, 0.05, 0.1)
        argv += ["--ar-order", str(pick(8, 16, 32, 64)), "--ridge", str(pick(0.0, 1e-6, 1e-5))]
        if rng.random() < 0.5:
            argv += ["--zeros", "--zero-order", str(pick(4, 8, 16))]
        if rng.random() < 0.2:
            argv.append("--no-trim")
        label = pick("damped", "modal")
    else:
        duration = pick(None, 0.3, 1.0)
        argv += [pick("--trim_to_peak", "--no-trim_to_peak"), "--magnitude_floor_db", str(pick(-140.0, -120.0, -100.0)),
                 "--f_min_hz", str(pick(20.0, 50.0)), "--f_max_hz", str(pick(10000.0, 20000.0)),
                 "--phase_mode", pick("degrees", "radians")]
        argv += [flag for flag in ("--no_unwrap_phase", "--no_hann_window") if rng.random() < 0.3]
        if rng.random() < 0.4:
            argv.append("--exact-grid")
        label = pick("tap", "verb")
    if duration is not None:
        argv += ["--duration", str(duration)]
    return argv, label


def zplane_ratio(card: str, cpu: str) -> float:
    """The largest ratio of a z-plane radius difference to its limit."""
    rel, abs_ = REST_TOLERANCES["zplane"]
    return max((abs(x - y) / max(abs_, rel * max(abs(x), abs(y)))
                for a, b in zip(zplane_lines(card), zplane_lines(cpu)) for x, y in zip(a[2:4], b[2:4])), default=0.0)


def fuzz_inputs(out_dir: Path, root: Path) -> dict:
    """The rest draws' inputs: the bundle's first tap, verb_ir.wav, the
    damped and modal IRs of tests/parity_matrix.py, its 1 s sweep and three
    recordings of it (the golden, modal and damped IRs cut to 2^16, 8192
    and 2048 samples, stereo, mono and stereo); a draw picks one."""
    import golden_utils
    import parity_matrix

    from audio_analysis_tpu_torch.io.wav import write_wav_pcm16

    inputs = {"tap": root / "taps" / "tap00.wav", "verb": REPO / "examples" / "gallery" / "verb_ir.wav"}
    irs = {"noise": golden_utils.make_golden_ir(), "damped": parity_matrix.make_damped_ir(),
           "modal": parity_matrix.make_modal_ir()}
    for name in ("damped", "modal"):
        inputs[name] = out_dir / f"{name}.wav"
        write_wav_pcm16(inputs[name], irs[name], SR)
    inputs["sweep"] = out_dir / "sweep.wav"
    write_wav_pcm16(inputs["sweep"], parity_matrix.make_sweep(), SR)
    for name, length, channels in (("noise", 1 << 16, 2), ("modal", 8192, 1), ("damped", 2048, 2)):
        key = f"recorded_{name}_{length}_{channels}"
        inputs[key] = out_dir / f"{key}.wav"
        write_wav_pcm16(inputs[key], parity_matrix.make_recorded(irs[name][:length, :channels]), SR)
    return inputs


def fuzz_rest(torch, cli_main, root: Path, counters, rng, seed: int) -> dict:
    """Drawn flag sets of filter, zplane, deconvolve and ir, and drawn gen
    subcommands (Karplus-Strong first), each through its CLI entry on the
    card and with --device cpu; K1, K2 and K4 launch 0 times, K3 once in a
    Karplus-Strong draw and 0 times in the others.
    The card run against the CPU run: filter's summaries within phase 9's
    tolerances (its exact-grid tolerance with --exact-grid), zplane by
    compare_zplane (pole counts exact, radii within REST_TOLERANCES, an
    unstable-count flip logged) with equal zero counts, the deconvolved IR
    within tests/_fuzz_spaces.py's DECONVOLVE_TOL (float32 against float32)
    of the CPU run's peak with equal WAV headers, ir's --json and stdout
    equal (the tightest it holds), gen's WAV bytes equal (K3 rounds as the
    plain version does). The worst ratio of a difference to its limit per
    command."""
    import shutil

    import numpy as np
    from scipy.io import wavfile

    sys.path.insert(0, str(REPO / "tests"))
    from _fuzz_spaces import DECONVOLVE_TOL, GEN_FLAGS
    from _summary_parity import assert_summaries_agree, json_skeleton

    from audio_analysis_tpu_torch.cli.gen_cli import main as gen_main

    out_dir = REPO / "build" / "chip_smoke_fuzz" / "rest"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    inputs = fuzz_inputs(out_dir, root)
    zero = {c.name: 0 for c in counters}
    worst = {cmd: 0.0 for cmd in ("filter", "zplane", "deconvolve", "ir")}
    flips, identical, karplus_launches = [], [], 0
    for i, cmd in enumerate(FUZZ_REST_COMMANDS):
        argv, label = draw_rest_argv(rng, cmd, inputs)
        fuzz_log("rest", i, seed, f"{' '.join(argv)} on {label}")

        def run(side):
            device = "cuda" if side == "card" else "cpu"
            if cmd == "deconvolve":
                return run_cli_text(torch, cli_main, [*argv, "--output_ir_wav_file_path", str(out_dir / f"{i}_{side}.wav"),
                                                      "--device", device])[1]
            return run_cli_text(torch, cli_main, [argv[0], "--input", str(inputs[label]), *argv[1:], "--json",
                                                  str(out_dir / f"{i}_{side}.json"), "--device", device])[1]

        card_out, launches = read_launches(counters, lambda: run("card"))
        if launches != zero:
            raise AssertionError(f"rest fuzz draw {i}: launches {launches}, expected none")
        cpu_out = run("cpu")
        if cmd == "deconvolve":
            a, b = wavfile.read(out_dir / f"{i}_card.wav")[1], wavfile.read(out_dir / f"{i}_cpu.wav")[1]
            ra, rb = (out_dir / f"{i}_card.wav").read_bytes(), (out_dir / f"{i}_cpu.wav").read_bytes()
            reg = float(argv[argv.index("--regularization_relative") + 1])
            limit = DECONVOLVE_TOL[reg][0] * float(np.abs(b).max())  # float32 on both sides
            err = float(np.abs(a.astype(np.float64) - b).max()) if a.shape == b.shape else math.inf
            if not (err <= limit and ra[: ra.index(b"data") + 8] == rb[: rb.index(b"data") + 8]):
                raise AssertionError(f"rest fuzz draw {i}: deconvolved IR {a.shape} vs {b.shape}, error {err} > {limit}")
            worst[cmd] = max(worst[cmd], err / limit)
            continue
        ours = json.loads((out_dir / f"{i}_card.json").read_text())
        ref = json.loads((out_dir / f"{i}_cpu.json").read_text())
        if json_skeleton(ours) != json_skeleton(ref):
            raise AssertionError(f"rest fuzz draw {i}: JSON keys of the card run and the CPU run differ")
        if cmd == "ir":
            if ours != ref or card_out.replace(f"{i}_card", "") != cpu_out.replace(f"{i}_cpu", ""):
                raise AssertionError(f"rest fuzz draw {i}: the card run and the CPU run differ")
        elif cmd == "zplane":
            def count(roots):  # a complex array is {"real", "imag"}, a real one a list
                return None if roots is None else len(roots["real"] if isinstance(roots, dict) else roots)

            if [count(c["zeros"]) for c in ours] != [count(c["zeros"]) for c in ref]:
                raise AssertionError(f"rest fuzz draw {i}: zero counts differ")
            found = compare_zplane(card_out.split("\n", 1)[1], cpu_out.split("\n", 1)[1], f"rest fuzz draw {i}")
            if found:
                flips.append({"draw": i, "flips": found})
                log(f"  rest fuzz draw {i}: unstable-pole count differs between the card and the CPU: {found}")
            worst[cmd] = max(worst[cmd], zplane_ratio(card_out.split("\n", 1)[1], cpu_out.split("\n", 1)[1]))
        else:
            tol = REST_TOLERANCES["exact_filter" if "--exact-grid" in argv else "filter"]
            ref_text, got = cpu_out.split("\n", 1)[1], card_out.split("\n", 1)[1]
            assert_summaries_agree(ref_text, got, *tol, f"rest fuzz draw {i}")
            worst[cmd] = max(worst[cmd], summary_ratio(ref_text, got, *tol))

    names = sorted(GEN_FLAGS)
    for j in range(FUZZ_GEN_DRAWS):
        cmd = "karplus_pluck" if j == 0 else names[int(rng.integers(len(names)))]
        flags = [x for flag, values in GEN_FLAGS[cmd].items() for x in (flag, str(values[int(rng.integers(len(values)))]))]
        common = ["--channel_mode", ("mono", "stereo")[int(rng.integers(2))],
                  "--sample_rate_hz", str((48_000, 44_100)[int(rng.integers(2))])]
        fuzz_log("gen", j, seed, " ".join([*common, cmd, *flags]))
        dirs = {side: out_dir / "gen" / str(j) / side for side in ("card", "cpu")}

        def gen(side):
            return run_cli_text(torch, gen_main, ["--output-dir", str(dirs[side]), *common, "--device",
                                                  "cuda" if side == "card" else "cpu", cmd, *flags])[1]

        card_out, launches = read_launches(counters, lambda: gen("card"))
        if launches != {**zero, "karplus": int(cmd == "karplus_pluck")}:
            raise AssertionError(f"gen fuzz draw {j}: launches {launches}, expected K3 {int(cmd == 'karplus_pluck')}")
        karplus_launches += launches["karplus"]
        if card_out.replace(str(dirs["card"]), "D") != gen("cpu").replace(str(dirs["cpu"]), "D"):
            raise AssertionError(f"gen fuzz draw {j}: stdout differs between the card and the CPU")
        wavs = sorted(p.name for p in dirs["cpu"].glob("*.wav"))
        if not wavs or sorted(p.name for p in dirs["card"].glob("*.wav")) != wavs:
            raise AssertionError(f"gen fuzz draw {j}: WAV files {wavs}")
        for name in wavs:
            identical.append((dirs["card"] / name).read_bytes() == (dirs["cpu"] / name).read_bytes())
            if not identical[-1]:
                raise AssertionError(f"gen fuzz draw {j}: {name} differs between the card and the CPU")
    out = {"draws": len(FUZZ_REST_COMMANDS) + FUZZ_GEN_DRAWS, "worst_ratio_card_vs_cpu": worst,
           "unstable_count_flips": flips, "gen_wavs_identical": f"{sum(identical)} of {len(identical)}",
           "launches": {**zero, "karplus": karplus_launches}, "card": card_line()}
    log(f"rest fuzz: worst ratio card vs cpu per command {worst}; gen WAVs byte-identical {out['gen_wavs_identical']}; "
        f"{out['card']}")
    return out


def fuzz_mesh(torch, root: Path, dev, counters, rng, seed: int) -> dict:
    """FUZZ_MESH_DRAWS meshes on the card, of 1 and 2 shards in turn, each
    over a drawn number of the bundle's taps with a drawn EngineConfig and
    chunk:
    bit-equal to the single-device run with the same taps a chunk, K1 and
    K2 launched per shard as expected_engine_launches says."""
    import numpy as np

    from audio_analysis_tpu_torch.engine import EngineConfig, analyze_bundle_pipelined, make_mesh
    from audio_analysis_tpu_torch.io import open_bundle_chunks_i16

    _meta, lengths, _names, n_max, loader = open_bundle_chunks_i16(root)
    draws, totals = [], dict.fromkeys(KERNELS, 0)
    for i in range(FUZZ_MESH_DRAWS):
        shards, taps, chunk = 1 + i % 2, int(rng.integers(1, 9)), int(rng.integers(1, 5))
        fields = draw_engine_fields(rng)
        fuzz_log("mesh", i, seed, {"shards": shards, "taps": taps, "chunk_taps": chunk, **fields})
        cfg = EngineConfig(**fields)
        lens = lengths[:taps]
        per_shard = max(1, min(chunk, -(-taps // shards)))
        mesh = make_mesh(devices=[dev] * shards)
        sharded, launches = read_launches(
            counters, lambda: analyze_bundle_pipelined(loader, lens, n_max, cfg, chunk, mesh=mesh, device=dev))
        k1, k2 = expected_engine_launches(cfg, per_shard, n_max)
        chunks = -(-taps // (per_shard * shards))
        want = (chunks * shards * k1, chunks * shards * k2, chunks * shards * k1)
        if (launches["edc"], launches["stft"], launches["dbfit"]) != want:
            raise AssertionError(f"mesh fuzz draw {i}: launches {launches}, expected {chunks} chunks x {shards} "
                                 f"shards x (K1 {k1}, K2 {k2}, K5 {k1})")
        single = analyze_bundle_pipelined(loader, lens, n_max, cfg, per_shard, device=dev)
        differing = sorted(k for k in single if not np.array_equal(sharded[k], single[k], equal_nan=True))
        if sorted(sharded) != sorted(single) or differing:
            raise AssertionError(f"mesh fuzz draw {i}: not bit-equal to the single-device run: {differing}")
        for name in totals:
            totals[name] += launches[name]
        draws.append({"shards": shards, "taps": taps, "chunk_taps": chunk, "launches": launches})
    return {"draws": draws, "bit_equal": True, "launches": totals}


def fuzz_phase(torch, cli_main, root: Path, dev, counters, launches_by_path: dict, seed: int) -> dict:
    """Phase 12: K1 and K2 at drawn shapes and settings against their plain
    versions and the port's float64 oracle, then drawn engine configs and
    per-file flag sets through their entry points, kernels against plain
    versions with exact launches. One numpy Generator from `seed`."""
    import numpy as np

    from audio_analysis_tpu_torch import oracle
    from audio_analysis_tpu_torch.ops import edc, stft

    log(f"fuzz seed {seed}")
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    out = {"seed": seed, "card": card_line()}
    out["k1"] = fuzz_k1(torch, edc, oracle, dev, rng, seed)
    out["k2"] = fuzz_k2(torch, stft, oracle, dev, rng, seed)
    out["engine"] = fuzz_engine(torch, root, dev, counters, rng, seed)
    out["per_file"] = fuzz_per_file(torch, cli_main, root, counters, rng, seed)
    out["rest"] = fuzz_rest(torch, cli_main, root, counters, rng, seed)
    out["mesh"] = fuzz_mesh(torch, root, dev, counters, rng, seed)
    launches_by_path["fuzz"] = {
        name: sum(out[part]["launches"][name] for part in ("engine", "per_file", "rest", "mesh")) for name in KERNELS
    }
    out["seconds"] = time.perf_counter() - t0
    log(f"fuzz: {out}")
    return out


def check_modules(reached, banned_roots) -> None:
    """Every module of `reached` (under audio_analysis_tpu_torch) loaded,
    and no module under `banned_roots`."""
    missing = [m for m in reached if "audio_analysis_tpu_torch." + m not in sys.modules]
    banned = sorted(m for m in sys.modules if m.split(".")[0] in banned_roots)
    if banned or missing:
        raise AssertionError(f"the port's path imported {banned}; did not load {missing}")


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.")
    parser.add_argument("--fuzz-seed", type=int, default=FUZZ_SEED,
                        help=f"seed of phase 12's draws (default {FUZZ_SEED}); a failing draw prints its seed")
    parser.add_argument("--fuzz-only", action="store_true",
                        help="run only the build, the bundle and phase 12 (to rerun a failing draw)")
    args = parser.parse_args(argv)
    if not (REPO / "audio_analysis_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke.py: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false; this run needs an NVIDIA GPU", file=sys.stderr)
        return 2

    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    phases = {}

    from audio_analysis_tpu_torch import _build
    from audio_analysis_tpu_torch.cli.analyse_cli import main as cli_main
    from audio_analysis_tpu_torch.engine import EngineConfig, analyze_batch, graphs
    from audio_analysis_tpu_torch.engine.batch import modal_tables
    from audio_analysis_tpu_torch.io import native, read_bundle_meta, write_bundle
    from audio_analysis_tpu_torch.ops import dbfit, display, edc, stft
    from audio_analysis_tpu_torch.signals import torchgen

    # 1. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    phases["build_s"] = time.perf_counter() - t0
    phases["ptxas"] = ptxas_report(lib_path.with_suffix(".log").read_text())
    for name, info in phases["ptxas"].items():
        log(f"ptxas {name}: {info}")
    missing = [kernel for kernel in PTXAS_KERNELS if kernel not in phases["ptxas"]]
    spilling = {k: v for k, v in phases["ptxas"].items() if v.get("spill_store_bytes") or v.get("spill_load_bytes")}
    if missing or spilling:
        raise AssertionError(f"ptxas' report: missing {missing}, spilling {spilling}")

    # 2. kernels vs plain versions on the card
    if not args.fuzz_only:
        t0 = time.perf_counter()
        g = torch.Generator().manual_seed(0)
        k_out = modal_tables(EngineConfig())[2]
        edc_err, edc_shapes = check_edc(torch, edc, dev, g)
        stft_err, stft_shapes = check_stft(torch, stft, dev, g, k_out)
        dbfit_err, dbfit_shapes = check_dbfit(torch, edc, dbfit, dev, g)
        phases["kernel_check_s"] = time.perf_counter() - t0

    # 3. the bundle
    t0 = time.perf_counter()
    if not native.ensure_built():
        raise RuntimeError("the native PCM16 bundle decoder (cpp/) did not build")
    root = REPO / "build" / "chip_smoke_bundle"
    if not (root / "meta.json").exists() or len(read_bundle_meta(root).taps) != TAPS:
        write_bench_bundle(root, write_bundle)
    phases["bundle_write_s"] = time.perf_counter() - t0
    counters = (edc.EDC_KERNEL, stft.STFT_KERNEL, torchgen.KARPLUS_KERNEL, display.POOL_KERNEL, dbfit.DBFIT_KERNEL)
    if args.fuzz_only:
        fuzz = fuzz_phase(torch, cli_main, root, dev, counters, {}, args.fuzz_seed)
        check_modules(FUZZ_MODULES, ("jax", "audio_analysis_tpu"))
        print(json.dumps({"fuzz": fuzz}))
        print(card_line())
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0

    # 4. the main path, through the CLI entry: the process's first bundle
    # of two chunks runs eagerly (one call of the key ahead, below
    # graphs.MIN_CALLS_AHEAD); the key has then ended a call, so the next
    # run captures after its first chunk and replays the second
    torch.cuda.reset_peak_memory_stats(dev)
    (phases["e2e_cold_s"], launches), cold_graphs = graph_runs(
        lambda: count_launches(counters, lambda: run_cli(cli_main, root, "reports_cuda")))
    launches_by_path = {MAIN_PATH: launches}
    phases["peak_device_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    phases["peak_device_memory_reserved_gib"] = torch.cuda.max_memory_reserved(dev) / 2**30
    if (cold_graphs["captures"], cold_graphs["replays"]) != (0, 0):
        raise AssertionError(f"main path: graphs {cold_graphs} in the first run, expected none")
    torch.cuda.reset_peak_memory_stats(dev)
    (phases["e2e_capture_s"], capture_launches), capture_graphs = graph_runs(
        lambda: count_launches(counters, lambda: run_cli(cli_main, root, "reports_cuda")))
    if (capture_graphs["captures"], capture_graphs["replays"]) != (1, 1) or capture_launches != launches:
        raise AssertionError(f"main path, second run: graphs {capture_graphs}, launches {capture_launches}")
    (key,) = graphs.STEP_GRAPHS.keys()
    phases["graphs_cold"] = cold_graphs
    phases["graphs_capture"] = {**capture_graphs, "capture_ms": graphs.STEP_GRAPHS.capture_ms(key),
                                "peak_device_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                                "peak_device_memory_reserved_gib": torch.cuda.max_memory_reserved(dev) / 2**30}
    log(f"main path launches: {launches}; graphs {cold_graphs} in the first run, {phases['graphs_capture']} "
        "in the second")

    # warm runs (device audio cache hits) through the graphs, under
    # eager() and with the plain versions swapped in, in turns on the same
    # card; eager() clears the graph cache, so the first graph run after
    # it captures again (`recapture`)
    warm = {"graphs": [], "recapture": [], "eager": [], "plain": []}
    for _round in range(3):
        for _ in range(2):
            wall, ran = graph_runs(lambda: run_cli(cli_main, root, "reports_cuda"))
            warm["recapture" if ran["captures"] else "graphs"].append(wall)
        with graphs.eager():
            warm["eager"].append(run_cli(cli_main, root, "reports_eager"))
        with plain_versions():
            warm["plain"].append(run_cli(cli_main, root, "reports_plain"))
    phases["e2e_warm_s"] = warm["graphs"]
    phases["e2e_recapture_s"] = warm["recapture"]
    phases["e2e_warm_eager_s"] = warm["eager"]
    phases["e2e_warm_plain_s"] = warm["plain"]
    cuda_json = json.loads((root / "reports_cuda" / "bundle_metrics.json").read_text())
    eager_json = json.loads((root / "reports_eager" / "bundle_metrics.json").read_text())
    phases["e2e_warm_phases"] = cuda_json["phases"]
    phases["e2e_warm_eager_phases"] = eager_json["phases"]

    # 5. checks, and the same run with the plain versions on the card
    names = cuda_json["taps"]
    for tap in names:
        if not (root / "reports_cuda" / tap / f"{tap}_report.md").is_file():
            raise AssertionError(f"missing markdown for {tap}")
    if len(names) != TAPS:
        raise AssertionError(f"{len(names)} taps in bundle_metrics.json")
    check_finite(cuda_json["metrics"])
    plain_json = json.loads((root / "reports_plain" / "bundle_metrics.json").read_text())
    compare_metrics(cuda_json["metrics"], plain_json["metrics"])
    for tap in names:
        compare_markdown(
            (root / "reports_cuda" / tap / f"{tap}_report.md").read_text(),
            (root / "reports_plain" / tap / f"{tap}_report.md").read_text(),
            tap,
        )
    log(f"kernel run == plain run on the card: {TAPS} taps, markdown and bundle_metrics.json")
    # the graph run (both chunks replayed) bit-equal to the eager() kernel run
    check_bit_equal(root, "reports_cuda", "reports_eager", names, "graph run vs eager() run")
    log(f"bundle_median_t30 {cuda_json['bundle_median_t30']}")

    # 6. where the device time of one chunk goes, and other loads
    phases["blocks_ms"] = block_times(torch, analyze_batch, EngineConfig, root, dev)
    phases["other_loads"] = other_loads(torch, cli_main, root, dev, counters)

    # 7. the rest of the engine fast path
    fast = fast_path_commands(torch, cli_main, root, dev, counters, launches_by_path, cuda_json)
    phases["other_loads"]["third_decimated"] = fast.pop("third_decimated")
    phases["fast_path"] = fast

    # 8. the per-file subcommands
    t0 = time.perf_counter()
    per_file = per_file_commands(torch, cli_main, root, dev, counters, launches_by_path)
    phases["per_file_s"] = time.perf_counter() - t0

    # 9. the rest of the per-file commands and the gen CLI
    t0 = time.perf_counter()
    rest = per_file_rest(torch, cli_main, root, dev, counters, launches_by_path)
    phases["per_file_rest_s"] = time.perf_counter() - t0
    phases["launches_by_path"] = launches_by_path

    # every module the paths loaded, the new ones of phase 9 included; no
    # path of phases 1-9 loads matplotlib
    check_modules(("analyses.filterplot", "analyses.zplane", "analyses.impulse_response", "signals.torchgen",
                   "cli.gen_cli"), ("jax", "matplotlib", "audio_analysis_tpu"))

    # 10. the plot reports
    t0 = time.perf_counter()
    plots = plots_phase(torch, cli_main, root, dev, counters, launches_by_path)
    phases["plots_s"] = time.perf_counter() - t0
    check_modules(("report.report", "report.bundle", "parallel.overlap"), ("jax", "audio_analysis_tpu"))

    # 11. the mesh and the multi-host job
    t0 = time.perf_counter()
    multi = multi_device_phase(torch, root, dev, counters, launches_by_path, cuda_json)
    phases["multi_device_s"] = time.perf_counter() - t0
    check_modules(("engine.mesh", "engine.distributed"), ("jax", "audio_analysis_tpu"))

    # 12. the settings fuzz
    fuzz = fuzz_phase(torch, cli_main, root, dev, counters, launches_by_path, args.fuzz_seed)
    phases["fuzz_s"] = fuzz["seconds"]
    check_modules(FUZZ_MODULES, ("jax", "audio_analysis_tpu"))
    phases["graph_stats"] = graphs.STEP_GRAPHS.stats()
    log("phases " + json.dumps(phases))

    def by_path(name):
        return {path: n[name] for path, n in launches_by_path.items()}

    k3, k4 = rest["karplus_kernel"], plots["pooled_image"]["k4"]
    kernels = [
        kernel_entry("schroeder_edc_db", "audio_analysis_tpu_torch/csrc/edc.cu",
                     "audio_analysis_tpu/ops/pallas_kernels.py:143", by_path("edc"), edc_err, edc_shapes),
        kernel_entry("stft_magnitude", "audio_analysis_tpu_torch/csrc/stft.cu",
                     "audio_analysis_tpu/ops/pallas_stft.py:219", by_path("stft"), stft_err, stft_shapes),
        kernel_entry("karplus_strong", "audio_analysis_tpu_torch/csrc/karplus.cu",
                     "audio_analysis_tpu/signals/jaxgen.py:46", by_path("karplus"), k3["max_abs_err"], k3["shapes"],
                     path=KARPLUS_PATH),
        kernel_entry("pooled_log_freq_image", "audio_analysis_tpu_torch/csrc/pool.cu",
                     "audio_analysis_tpu/ops/display.py:151", by_path("pool"), k4["max_abs_err"], k4["shapes"],
                     path=POOL_PATH),
        kernel_entry("decay_fits", "audio_analysis_tpu_torch/csrc/dbfit.cu", None, by_path("dbfit"), dbfit_err,
                     dbfit_shapes),
    ]
    for k in kernels:
        numbers = [k["max_abs_err"], k["ms"], k["plain_ms"], k["bound_ms"]]
        if k["library_ms"] is not None:
            numbers.append(k["library_ms"])
        if not all(math.isfinite(v) for v in numbers):
            raise AssertionError(f"non-finite measurement for {k['name']}")
    print(json.dumps({"per_file": per_file}))
    print(json.dumps({"per_file_rest": rest}))
    print(json.dumps({"plots": plots}))
    print(json.dumps({"multi_device": multi}))
    print(json.dumps({"fuzz": fuzz}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
