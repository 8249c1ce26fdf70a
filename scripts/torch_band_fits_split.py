#!/usr/bin/env python3
"""
Where the engine's band and broadband decay fits spend their device time, on
one NVIDIA GPU. Run from the repository root:

    python3 scripts/torch_band_fits_split.py [--reps 5]

One chunk of 8 stereo taps of 1,155,072 samples (the 24 s bundle tap padded
to the decoder's multiple of 4096): decaying noise with a direct impulse
at a delay drawn in [64, 2048) per channel (so three starts in four are
off the 16-byte grid), T60 drawn log-uniform in 0.5-8 s per tap, seed 0.
Four planes, as the engine step forms them:

- third: one stereo tap's third-octave bands, (2, 26, N), the per-tap loop
  of the bands block (engine/batch.py `_band_fits`);
- third_16ch: one 16-channel tap's (the chunk's 16 channels as one tap),
  (16, 26, N);
- three: the chunk's three bands, (8, 2, 3, N);
- broadband: the chunk's aligned channels, (8, 2, N), the decay block.

For each band plane, the stages of `_band_fits` one at a time: the band
plane (`fftmask.apply_band_masks`: mask, c2c inverse, real/imag stack);
K1 reading each row from its start (`k1_starts`, the route the engine
takes, where the tree's `edc.schroeder_edc_db` has `start`); the route it
replaced, the alignment (`trim.shift_to`) and K1 without starts on the
shifted plane (`k1`), each with K1's bound (one read and one write of the
plane at 3.35 TB/s, `bound_ms`); the three fits (T30, T20, EDT) through
`dbfit.fit_decay_slope_over_db_range` one range at a time (`fits_plain`)
and, where the tree has it, through `dbfit.fit_decay_ranges` (`fits_k5`);
and `_band_fits` whole. Each stage is
timed two ways: CUDA events around `--reps` back-to-back calls after a warm
call (ms a call, stream time), and the sum of its device kernels' durations
under torch.profiler for one call (`device_ms`, the four longest kernels by
name in `top_ms`). Beside K5's times, its
bounds at 3.35 TB/s: two reads of the plane (`two_reads_ms`), and the
bytes these curves need (`needed_ms`): each row read up to the first
index at or below its last level (its length where a level is never
reached) and the union of its windows read once. The ptxas report of K5's
two kernels is printed from the build log.

Prints the card's name and power limit first and one JSON line last. Needs
CUDA; no result without it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SR = 48_000
N = 1_155_072
TAPS = 8


def chunk(torch, dev):
    """(TAPS, 2, N) float32 decaying noise with a direct impulse at a
    delay drawn in [64, 2048) per channel."""
    g = torch.Generator(device=dev).manual_seed(0)
    t60 = torch.exp(torch.empty(TAPS, 1, 1, device=dev).uniform_(0.0, 1.0, generator=g) * 2.7726) * 0.5
    delay = torch.randint(64, 2048, (TAPS, 2, 1), device=dev, generator=g)
    since = torch.arange(N, device=dev)[None, None, :] - delay
    x = 0.3 * torch.randn(TAPS, 2, N, device=dev, generator=g) * 10.0 ** (-3.0 * since.clamp(min=0) / SR / t60)
    x = torch.where(since < 0, 0.0, torch.where(since == 0, 0.9, x))
    return x, torch.full((TAPS,), N - 3072, dtype=torch.int32, device=dev)


def timed(torch, fn, reps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ms = []
    for _ in range(3):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end) / reps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.profiler.kineto_results.events() if e.device_type().name == "CUDA"]
    by_name = {}
    for e in kernels:
        name = e.name()[:48]
        by_name[name] = by_name.get(name, 0.0) + e.duration_ns() * 1e-6
    return {
        "ms": statistics.median(ms),
        "ms_rounds": ms,
        "device_ms": sum(e.duration_ns() for e in kernels) * 1e-6,
        "device_events": len(kernels),
        "top_ms": sorted(by_name.items(), key=lambda kv: -kv[1])[:4],
    }


def k5_bounds(torch, curve, length, ranges, fit_lower: float, fits) -> dict:
    """K5's two-read bound and the bytes these curves need, in ms at
    3.35 TB/s."""
    from audio_analysis_tpu_torch.ops import dbfit
    from audio_analysis_tpu_torch.ops.common import bool_valid_mask

    n = curve.shape[-1]
    valid = bool_valid_mask(n, length)
    rows = curve.numel() // n
    levels = {lv for high, low in ranges for lv in (float(high), max(float(low), fit_lower))}
    prefix = torch.zeros(curve.shape[:-1], dtype=torch.int64, device=curve.device)
    for level in levels:
        below = (curve <= level) & valid
        reach = torch.where(below.any(-1), torch.argmax(below.to(torch.uint8), -1) + 1, length.to(torch.int64))
        prefix = torch.maximum(prefix, reach)
    t = torch.arange(n, device=curve.device, dtype=torch.float32) * dbfit._seconds_per_sample(SR)
    union = torch.zeros_like(valid)
    for fit in fits:
        union |= valid & (t >= fit.start_time_seconds[..., None]) & (t <= fit.end_time_seconds[..., None])
    needed = 4 * (int(prefix.sum()) + int(union.sum()))
    return {"two_reads_ms": 8 * rows * n / 3.35e9, "needed_ms": needed / 3.35e9, "needed_bytes": needed}


def stages(torch, plane_fn, start, length, config, sr: float, reps: int) -> dict:
    """The stages of `_band_fits` on the band plane plane_fn() returns."""
    import inspect

    from audio_analysis_tpu_torch.engine import batch
    from audio_analysis_tpu_torch.ops import dbfit, edc, trim

    ranges = (config.t30_range_db, config.t20_range_db, config.edt_range_db)
    out = {}
    plane = plane_fn()
    out["plane"] = timed(torch, plane_fn, reps)
    shape = plane.shape[:-1]
    bound_ms = plane.numel() * 8 / 3.35e9
    st, ln = start[..., None].expand(shape), length[..., None].expand(shape)
    if "start" in inspect.signature(edc.schroeder_edc_db).parameters:
        out["k1_starts"] = timed(torch, lambda: edc.schroeder_edc_db(
            plane, ln, config.edc_epsilon, config.edc_floor_db, start=st), reps)
        out["k1_starts"]["bound_ms"] = bound_ms
    out["shift_to"] = timed(torch, lambda: trim.shift_to(plane, st, ln), reps)
    aligned = trim.shift_to(plane, st, ln)
    out["k1"] = timed(torch, lambda: edc.schroeder_edc_db(aligned.samples, aligned.length,
                                                          config.edc_epsilon, config.edc_floor_db), reps)
    out["k1"]["bound_ms"] = bound_ms
    curve = edc.schroeder_edc_db(aligned.samples, aligned.length, config.edc_epsilon, config.edc_floor_db)
    del aligned

    def fits_plain():
        return [dbfit.fit_decay_slope_over_db_range(curve.edc_db, curve.length, r, config.fit_lower_limit_db, sr)
                for r in ranges]

    out["fits_plain"] = timed(torch, fits_plain, reps)
    if hasattr(dbfit, "fit_decay_ranges"):
        out["fits_k5"] = timed(torch, lambda: dbfit.fit_decay_ranges(
            curve.edc_db, curve.length, ranges, config.fit_lower_limit_db, sr), reps)
        fits = dbfit.fit_decay_ranges(curve.edc_db, curve.length, ranges, config.fit_lower_limit_db, sr)
        out["fits_k5"].update(k5_bounds(torch, curve.edc_db, curve.length, ranges, config.fit_lower_limit_db, fits))
    del curve
    out["band_fits_whole"] = timed(torch, lambda: batch._band_fits(plane_fn(), start, length, 1, config), reps)
    out["rows"] = int(plane.numel() // plane.shape[-1])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from audio_analysis_tpu_torch import _build
    from audio_analysis_tpu_torch.engine import EngineConfig, batch
    from audio_analysis_tpu_torch.ops import dbfit, edc, fftmask, trim

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    x, lengths = chunk(torch, dev)
    out = {"card": card, "torch": torch.__version__, "n": N, "taps": TAPS, "reps": args.reps}
    for mode in ("third", "third_16ch", "three"):
        config = replace(EngineConfig(), band_mode=mode.split("_")[0])
        tables = batch._device_tables(config, N, dev)
        lengths_bc = lengths[:, None].expand(TAPS, 2)
        aligned = trim.align_for_analysis(x, lengths_bc, SR, config.trim_to_peak, config.ignore_leading_seconds)
        if mode == "third":
            tap, start, length = x[0], aligned.start_index[0], lengths_bc[0]
        elif mode == "third_16ch":
            tap, start, length = x.reshape(2 * TAPS, N), aligned.start_index.reshape(-1), lengths_bc.reshape(-1)
        else:
            tap, start, length = x, aligned.start_index, lengths_bc
        masks = tables["band_masks"]
        out[mode] = stages(torch, lambda: fftmask.apply_band_masks(tap, masks), start, length, config, SR, args.reps)
        print(f"{mode}: " + json.dumps(out[mode]), flush=True)
        del aligned

    config = EngineConfig()
    aligned = trim.align_for_analysis(x, lengths[:, None].expand(TAPS, 2), SR, config.trim_to_peak,
                                      config.ignore_leading_seconds)
    curve = edc.schroeder_edc_db(aligned.samples, aligned.length, config.edc_epsilon, config.edc_floor_db)
    ranges = (config.edt_range_db, config.t20_range_db, config.t30_range_db)
    broadband = {"rows": TAPS * 2, "fits_plain": timed(torch, lambda: [
        dbfit.fit_decay_slope_over_db_range(curve.edc_db, curve.length, r, config.fit_lower_limit_db, SR)
        for r in ranges], args.reps)}
    if hasattr(dbfit, "fit_decay_ranges"):
        broadband["fits_k5"] = timed(torch, lambda: dbfit.fit_decay_ranges(
            curve.edc_db, curve.length, ranges, config.fit_lower_limit_db, SR), args.reps)
        fits = dbfit.fit_decay_ranges(curve.edc_db, curve.length, ranges, config.fit_lower_limit_db, SR)
        broadband["fits_k5"].update(k5_bounds(torch, curve.edc_db, curve.length, ranges, config.fit_lower_limit_db,
                                              fits))
        # ptxas' lines from each K5 kernel's "Compiling entry function" to
        # the next kernel's
        out["k5_ptxas"], keep = [], False
        for line in _build.library_path().with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                keep = "dbfit" in line
            if keep:
                out["k5_ptxas"].append(line.strip())
    out["broadband"] = broadband
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
