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
          alone, is logged beside it);
       K2 STFT magnitude: 16 rows x 2^20 at (4096, 512) and at (8192, 512)
          with the modal k_out; max |err| / max(ref) < 1e-5; library call
          torch.stft(center=False, Hann) + abs;
  3. write a deterministic 16-tap stereo bundle of 2^20 samples per tap
     (bench.py's recipe) under build/;
  4. drive `bundle --no-plots` of the port through its CLI entry, 8 taps
     per chunk, with the kernels' launch counters set to 0 just before and
     read just after (each must be > 0); then warm runs with the kernels
     and with the plain versions swapped in, alternating;
  5. check the run: every tap's markdown and bundle_metrics.json exist,
     metrics are finite where their *_ok flag is set, and the same run with
     the plain torch versions swapped in on the card agrees (markdown line
     by line, numbers within 2 units of the printed precision + 2e-3
     relative; JSON integers and flags exact, floats within 1e-4, per-bin
     modal fits 1e-2, group delay 1e-3 relative);
  6. where one chunk's device time goes (profiler device-busy time, each
     block toggled off in turn), and the bundle under other loads: octave
     and third-octave bands, every chunk decoded and uploaded again, and
     the device's busy share of a warm run.

The port's path must not load jax, matplotlib or the JAX package
(audio_analysis_tpu). The last lines are the kernels' JSON, the card's name
and power limit, and {"ok": true, "device": {...}}. There is no CPU fallback: without CUDA the
script exits non-zero at once.
"""

from __future__ import annotations

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


def ptxas_report(build_log: str) -> dict:
    """Registers, spill bytes and static shared memory of every kernel
    instance, from the `-Xptxas -v` lines of the build log."""
    report, name = {}, None
    for line in build_log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            m = re.search(r"([a-z_]+_kernel)(?:IL[a-z](\d+)E)?", entry.group(1))
            name = (m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")) if m else entry.group(1)
            report[name] = {}
        elif name and "spill stores" in line:
            stores, loads = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            report[name].update(spill_store_bytes=int(stores), spill_load_bytes=int(loads))
        elif name and "registers" in line:
            report[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            report[name]["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return report


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
    return worst, shapes


def check_stft(torch, stft, dev, g, k_out):
    """K2 against its plain version; returns (max abs err, per-shape
    timings)."""
    worst = 0.0
    shapes = []
    x = torch.randn(16, N, generator=g).to(dev)
    lengths = torch.full((16,), N, dtype=torch.int32, device=dev)
    lengths[3] = 500_000
    floor_lin = 10.0 ** (-120.0 / 20.0)
    for n_fft, hop, kk in ((4096, 512, None), (8192, 512, k_out)):
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
        shapes.append({"shape": [rows, N, n_fft, hop, bins], "ms": k, "plain_ms": p, "bound_ms": b,
                       "bound_by": by, "library_ms": lib})
        log(
            f"K2 stft (16, {N}) n_fft={n_fft} hop={hop} k_out={kk}: shape {tuple(got.shape)} "
            f"max err {err:.3g} (rel {rel:.3g}); kernel {k:.3f} ms, plain {p:.3f} ms, "
            f"torch.stft+abs {lib:.3f} ms ({lib / k:.2f}x the kernel's speed), "
            f"bound {b:.3f} ms ({by}), {b / k:.0%} of bound"
        )
    return worst, shapes


def kernel_entry(name, source, replaces, launch_count, err, shapes) -> dict:
    """One kernel of the kernels line: times, bounds and library times summed
    over its calls in one chunk, with each call's numbers under `shapes`."""
    libs = [sh["library_ms"] for sh in shapes]
    ms = sum(sh["ms"] for sh in shapes)
    bound_ms = sum(sh["bound_ms"] for sh in shapes)
    kinds = {sh["bound_by"] for sh in shapes}
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launch_count, "max_abs_err": err,
        "ms": ms, "plain_ms": sum(sh["plain_ms"] for sh in shapes),
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
    }


def block_times(torch, analyze_batch, EngineConfig, root: Path, dev) -> dict:
    """Where one 8-tap chunk's device time goes. `chunk_elapsed_ms` is the
    stream's elapsed time (CUDA events), which also holds the device's idle
    gaps while the host enqueues the eager ops; the other entries are
    device-busy time from torch.profiler: all blocks on, and each block as
    the drop when it alone is toggled off."""
    import numpy as np

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
    for label, flags in (
        ("bands", ("run_bands",)),
        ("fr_group_delay", ("run_fr", "run_group_delay")),
        ("stft", ("run_stft",)),
        ("modal", ("run_modal",)),
        ("diffusion", ("run_diffusion",)),
    ):
        out[label + "_busy_ms"] = full - busy_ms(replace(base, **{f: False for f in flags}))
    out["align_decay_busy_ms"] = busy_ms(
        replace(
            base, run_bands=False, run_fr=False, run_group_delay=False, run_stft=False,
            run_modal=False, run_diffusion=False,
        )
    )
    return out


def other_loads(torch, cli_main, root: Path, dev) -> dict:
    """The same bundle under other loads: the octave and third-octave band
    modes (cold, 3 warm, peak memory), every chunk decoded and uploaded
    again (3 runs), and the device's busy share of one warm run."""
    from audio_analysis_tpu_torch.report import EngineBundleSettings, run_bundle_report_engine

    out = {}
    for bands in ("octave", "third"):
        torch.cuda.reset_peak_memory_stats(dev)
        cold = run_cli(cli_main, root, "reports_" + bands, "--bands", bands)
        warm = [run_cli(cli_main, root, "reports_" + bands, "--bands", bands) for _ in range(3)]
        out[bands] = {
            "cold_s": cold,
            "warm_s": warm,
            "peak_device_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        }
    uncached = EngineBundleSettings(reports_subdir="reports_uncached", cache_device_audio=False)
    out["uncached_s"] = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_bundle_report_engine(root, uncached, dev)
        torch.cuda.synchronize()
        out["uncached_s"].append(time.perf_counter() - t0)
    out["warm_profiled"] = device_busy(torch, lambda: run_cli(cli_main, root, "reports_cuda"))
    return out


def main() -> int:
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
    from audio_analysis_tpu_torch.engine import EngineConfig, analyze_batch
    from audio_analysis_tpu_torch.engine.batch import modal_tables
    from audio_analysis_tpu_torch.io import native, read_bundle_meta, write_bundle
    from audio_analysis_tpu_torch.ops import edc, stft

    # 1. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    phases["build_s"] = time.perf_counter() - t0
    phases["ptxas"] = ptxas_report(lib_path.with_suffix(".log").read_text())
    for name, info in phases["ptxas"].items():
        log(f"ptxas {name}: {info}")
    edc_ptxas = phases["ptxas"].get("edc_kernel")
    if not edc_ptxas or edc_ptxas.get("spill_store_bytes") or edc_ptxas.get("spill_load_bytes"):
        raise AssertionError(f"K1 edc_kernel missing from ptxas' report or spilling: {edc_ptxas}")

    # 2. kernels vs plain versions on the card
    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(0)
    k_out = modal_tables(EngineConfig())[2]
    edc_err, edc_shapes = check_edc(torch, edc, dev, g)
    stft_err, stft_shapes = check_stft(torch, stft, dev, g, k_out)
    phases["kernel_check_s"] = time.perf_counter() - t0

    # 3. the bundle
    t0 = time.perf_counter()
    if not native.ensure_built():
        raise RuntimeError("the native PCM16 bundle decoder (cpp/) did not build")
    root = REPO / "build" / "chip_smoke_bundle"
    if not (root / "meta.json").exists() or len(read_bundle_meta(root).taps) != TAPS:
        write_bench_bundle(root, write_bundle)
    phases["bundle_write_s"] = time.perf_counter() - t0

    # 4. the main path, through the CLI entry
    counters = (edc.EDC_KERNEL, stft.STFT_KERNEL)
    for counter in counters:
        counter.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    phases["e2e_cold_s"] = run_cli(cli_main, root, "reports_cuda")
    launches = {c.name: c.launches for c in counters}
    phases["peak_device_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"main path launches: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    # warm runs (device audio cache hits) with the kernels and with the
    # plain versions swapped in, alternating on the same card
    warm = {"kernels": [], "plain": []}
    for side in ("kernels", "plain", "plain", "kernels", "kernels", "plain"):
        if side == "kernels":
            warm[side].append(run_cli(cli_main, root, "reports_cuda"))
            continue
        with mock.patch.object(edc, "schroeder_edc_db_cuda", edc.schroeder_edc_db_plain), \
                mock.patch.object(stft, "stft_magnitude_cuda", stft.stft_magnitude_plain):
            warm[side].append(run_cli(cli_main, root, "reports_plain"))
    phases["e2e_warm_s"] = warm["kernels"]
    phases["e2e_warm_plain_s"] = warm["plain"]
    cuda_json = json.loads((root / "reports_cuda" / "bundle_metrics.json").read_text())
    phases["e2e_warm_phases"] = cuda_json["phases"]

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
    log(f"bundle_median_t30 {cuda_json['bundle_median_t30']}")

    # 6. where the device time of one chunk goes, and other loads
    phases["blocks_ms"] = block_times(torch, analyze_batch, EngineConfig, root, dev)
    phases["other_loads"] = other_loads(torch, cli_main, root, dev)

    banned = sorted(
        m for m in sys.modules
        if m in ("jax", "matplotlib", "audio_analysis_tpu")
        or m.startswith(("jax.", "matplotlib.", "audio_analysis_tpu."))
    )
    if banned:
        raise AssertionError(f"the port's path imported {banned}")
    log("phases " + json.dumps(phases))

    kernels = [
        kernel_entry("schroeder_edc_db", "audio_analysis_tpu_torch/csrc/edc.cu",
                     "audio_analysis_tpu/ops/pallas_kernels.py:143", launches["edc"], edc_err, edc_shapes),
        kernel_entry("stft_magnitude", "audio_analysis_tpu_torch/csrc/stft.cu",
                     "audio_analysis_tpu/ops/pallas_stft.py:219", launches["stft"], stft_err, stft_shapes),
    ]
    for k in kernels:
        numbers = [k["max_abs_err"], k["ms"], k["plain_ms"], k["bound_ms"]]
        if k["library_ms"] is not None:
            numbers.append(k["library_ms"])
        if not all(math.isfinite(v) for v in numbers):
            raise AssertionError(f"non-finite measurement for {k['name']}")
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
