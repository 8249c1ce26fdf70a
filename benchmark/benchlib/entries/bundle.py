"""
Entry `bundle`: the iterate loop of `bundle --no-plots` and `watch`, one call
of `audio_analysis_tpu_torch.report.engine_report.run_bundle_report_engine`
over a capture bundle a operation's worth of taps.

Set-up draws `inputs` captures from the seed and writes them, then warms
the program up with one call on each. In the window the calls go round the
captures, each stamped with a new mtime first (os.utime; no byte is
rewritten), as a re-recording leaves them: neither the device audio cache
nor the WAV read cache can serve a call from memory, while the OS page
cache stays warm as it is right after the recorder writes.

After the window every call's bundle_metrics.json, kept as bytes when the
call returned, is judged against the reference in reference/engine.py:
each metric of each tap, gathered into the families that `gaps` reads.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import replace
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from benchlib import capture
from reference import engine as ref_engine
from reference import tables

FIT_KEYS = ("rt60", "slope", "t_start", "t_end")
DECAY_FITS = ("edt", "t20", "t30")
BAND_FITS = ("t30", "t20", "edt")
DIFFUSION_KEYS = ("diff_median_autocorr", "diff_median_echo_density")
STEREO_KEYS = ("diff_median_corr0", "diff_median_iacc")
FAMILIES = ("decay_gap", "band_gap", "spectrum_gap", "group_delay_gap", "modal_gap", "modal_bin_gap",
            "diffusion_gap")


def _rel(p, r, floor: float) -> float:
    p, r = float(p), float(r)
    if math.isnan(p) and math.isnan(r):
        return 0.0
    if math.isnan(p) or math.isnan(r):
        return 1.0
    return abs(p - r) / max(abs(r), floor)


class Worst:
    """The largest gap of each family, with where it was read."""

    def __init__(self) -> None:
        self.value = {f: 0.0 for f in FAMILIES}
        self.where = {f: "" for f in FAMILIES}

    def add(self, family: str, gap: float, where: str) -> None:
        if gap > self.value[family] or (math.isnan(gap) and not math.isnan(self.value[family])):
            self.value[family] = gap if not math.isnan(gap) else 1.0
            self.where[family] = where

    def merge(self, other: "Worst") -> None:
        for f in FAMILIES:
            self.add(f, other.value[f], other.where[f])


def gaps(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray], fr_mag: torch.Tensor, n: int,
         sample_rate_hz: int, label: str) -> Worst:
    """Every metric of one tap against the reference, as the widest gap of
    each family. Relative gaps are taken against the reference's value (or
    a floor); an integer, a flag or an answer that is missing counts 1.0.

    decay: start index, segment length, peak, early decay, and the EDT, T20
      and T30 fits (rt60, slope, crossing times relative; r2 absolute);
    band: each band's T30/T20/EDT rt60;
    spectrum: the FR peak as the share by which the reference's magnitude
      at the program's peak lies below its own maximum, the FR centroid,
      the STFT frame count and the STFT maximum's linear ratio;
    group delay: the p10, median and p90 against the larger of the value
      and the reference's p10-p90 spread;
    modal: the count of reliable bins (over the reference's count) and the
      median, p90 and maximum rt60;
    modal bins: each log bin's rt60 (relative) and r2 (absolute) where both
      sides found the bin reliable, and the bins reliable on one side alone
      (their NaN) over the reference's reliable bins: a bin sits on the
      fit's ten-point threshold now and then, and float32 flips it;
    diffusion: the frame count, and the medians' absolute gaps."""
    w = Worst()
    channels = ref["start_index"].shape[0]
    for c in range(channels):
        at = f"{label} ch{c}"
        for key in ("start_index", "segment_length"):
            if int(prog[key][c]) != int(ref[key][c]):
                w.add("decay_gap", 1.0, f"{at} {key}")
        w.add("decay_gap", _rel(prog["peak_abs"][c], ref["peak_abs"][c], 1e-6), f"{at} peak_abs")
        if bool(prog["early10_ok"][c]) != bool(ref["early10_ok"][c]):
            w.add("decay_gap", 1.0, f"{at} early10_ok")
        elif bool(ref["early10_ok"][c]):
            w.add("decay_gap", _rel(prog["early10_time"][c], ref["early10_time"][c], 1e-3), f"{at} early10_time")
        for fit in DECAY_FITS:
            ok_p, ok_r = bool(prog[f"{fit}_ok"][c]), bool(ref[f"{fit}_ok"][c])
            if ok_p != ok_r:
                w.add("decay_gap", 1.0, f"{at} {fit}_ok")
                continue
            if not ok_r:
                continue
            for k in FIT_KEYS:
                floor = 1e-3 if k.startswith("t_") else 1e-12
                w.add("decay_gap", _rel(prog[f"{fit}_{k}"][c], ref[f"{fit}_{k}"][c], floor), f"{at} {fit}_{k}")
            w.add("decay_gap", abs(float(prog[f"{fit}_r2"][c]) - float(ref[f"{fit}_r2"][c])), f"{at} {fit}_r2")
        for fit in BAND_FITS:
            okp, okr = np.asarray(prog[f"band_{fit}_ok"][c], bool), np.asarray(ref[f"band_{fit}_ok"][c], bool)
            for b in range(okr.shape[0]):
                if okp[b] != okr[b]:
                    w.add("band_gap", 1.0, f"{at} band{b} {fit}_ok")
                elif okr[b]:
                    w.add("band_gap", _rel(prog[f"band_{fit}_rt60"][c][b], ref[f"band_{fit}_rt60"][c][b], 1e-12),
                          f"{at} band{b} {fit}_rt60")
        # FR peak: how far below the reference's maximum the program's bin lies
        k = int(round(float(prog["fr_peak_hz"][c]) * n / sample_rate_hz))
        mag = fr_mag[c]
        if 0 <= k < mag.shape[0]:
            w.add("spectrum_gap", float(1.0 - mag[k] / mag.max()), f"{at} fr_peak_hz")
        else:
            w.add("spectrum_gap", 1.0, f"{at} fr_peak_hz")
        w.add("spectrum_gap", _rel(prog["fr_centroid_hz"][c], ref["fr_centroid_hz"][c], 1.0), f"{at} fr_centroid_hz")
        gd_scale = abs(float(ref["gd_p90"][c]) - float(ref["gd_p10"][c]))
        for key in ("gd_p10", "gd_median", "gd_p90"):
            w.add("group_delay_gap", _rel(prog[key][c], ref[key][c], gd_scale), f"{at} {key}")
        if int(prog["stft_num_frames"][c]) != int(ref["stft_num_frames"][c]):
            w.add("spectrum_gap", 1.0, f"{at} stft_num_frames")
        w.add("spectrum_gap", abs(10.0 ** ((float(prog["stft_global_max_db"][c])
                                            - float(ref["stft_global_max_db"][c])) / 20.0) - 1.0),
              f"{at} stft_global_max_db")
        count_r = int(ref["modal_count"][c])
        w.add("modal_gap", abs(int(prog["modal_count"][c]) - count_r) / max(count_r, 1), f"{at} modal_count")
        for key in ("modal_median_rt60", "modal_p90_rt60", "modal_max_rt60"):
            w.add("modal_gap", _rel(prog[key][c], ref[key][c], 1e-12), f"{at} {key}")
        rt_p, rt_r = np.asarray(prog["modal_rt60"][c], np.float64), np.asarray(ref["modal_rt60"][c], np.float64)
        r2_p, r2_r = np.asarray(prog["modal_r2"][c], np.float64), np.asarray(ref["modal_r2"][c], np.float64)
        if rt_p.shape != rt_r.shape or r2_p.shape != r2_r.shape:
            w.add("modal_bin_gap", 1.0, f"{at} modal bins shape")
        else:
            both = ~np.isnan(rt_r) & ~np.isnan(rt_p)
            flips = np.flatnonzero((np.isnan(rt_p) != np.isnan(rt_r)) | (np.isnan(r2_p) != np.isnan(rt_r)))
            if flips.size:
                w.add("modal_bin_gap", flips.size / max(int((~np.isnan(rt_r)).sum()), 1),
                      f"{at} modal bin {int(flips[0])} reliable on one side ({flips.size} bins)")
            if both.any():
                rel = np.abs(rt_p[both] - rt_r[both]) / np.maximum(np.abs(rt_r[both]), 1e-12)
                j = int(np.argmax(rel))
                w.add("modal_bin_gap", float(rel[j]), f"{at} modal bin {int(np.flatnonzero(both)[j])} rt60")
                ok2 = both & ~np.isnan(r2_p) & ~np.isnan(r2_r)
                if ok2.any():
                    d2 = np.abs(r2_p[ok2] - r2_r[ok2])
                    j = int(np.argmax(d2))
                    w.add("modal_bin_gap", float(d2[j]), f"{at} modal bin {int(np.flatnonzero(ok2)[j])} r2")
        if int(prog["diff_num_frames"][c]) != int(ref["diff_num_frames"][c]):
            w.add("diffusion_gap", 1.0, f"{at} diff_num_frames")
        for key in DIFFUSION_KEYS:
            w.add("diffusion_gap", _rel(prog[key][c], ref[key][c], 1.0), f"{at} {key}")
    for key in STEREO_KEYS:
        if key in ref:
            w.add("diffusion_gap", _rel(np.asarray(prog[key]).reshape(()), np.asarray(ref[key]).reshape(()), 1.0),
                  f"{label} {key}")
    return w


class Entry:
    def __init__(self, cell, seed: int, device: str, workdir: Path, scale: dict | None = None):
        self.seed, self.device = int(seed), torch.device(device)
        self.config = dict(cell.config, **(scale or {}))
        self.mix = cell.mix
        self.workdir = Path(workdir)
        self.taps = int(self.config["taps"])
        self.samples_per_tap = int(self.config["samples"])
        self.sr = int(self.config["sample_rate_hz"])
        self.roots: List[Path] = []
        self.inputs: List[np.ndarray] = []
        self.paths: List[List[Path]] = []
        self._stamp = 0

    # ------------------------------------------------------------ set-up

    def settings(self):
        """The settings `bundle --no-plots --bands <mode>` gives: the
        program's defaults, the band mode the mix's."""
        from audio_analysis_tpu_torch.engine.config import EngineConfig
        from audio_analysis_tpu_torch.report.engine_report import EngineBundleSettings

        return EngineBundleSettings(config=replace(EngineConfig(), band_mode=self.mix["band_mode"]))

    def make_inputs(self) -> None:
        """Draw and write the mix's captures; keep their samples on the host
        for the reference."""
        for k in range(int(self.mix["inputs"])):
            drawn = capture.decaying_taps(self.seed, k, self.taps, int(self.config["channels"]),
                                          self.samples_per_tap, self.sr, self.config["content"], self.device)
            root = self.workdir / f"capture{k}"
            self.paths.append(capture.write_capture(root, drawn["samples"], self.sr))
            self.inputs.append(drawn["samples"].cpu().numpy())
            self.roots.append(root)
            del drawn

    def setup(self) -> None:
        from audio_analysis_tpu_torch.report import engine_report

        self._run = engine_report.run_bundle_report_engine
        self._settings = self.settings()
        t0 = time.perf_counter()
        self.make_inputs()
        t1 = time.perf_counter()
        for k in range(len(self.roots)):
            self.call(k)
        self.warm_calls = len(self.roots)
        self.setup_parts = {"inputs": t1 - t0, "warm_calls": time.perf_counter() - t1}

    # ------------------------------------------------------------ the timed call

    def _touch(self, k: int) -> None:
        """A new mtime on every tap of input k, as a re-recording leaves it."""
        self._stamp = max(time.time_ns(), self._stamp + 1_000_000)
        for p in self.paths[k]:
            os.utime(p, ns=(self._stamp, self._stamp))

    def call(self, i: int) -> dict:
        k = i % len(self.roots)
        self._touch(k)
        rec = {"input": k, "ops": self.taps}
        out = self.roots[k] / self._settings.reports_subdir / "bundle_metrics.json"
        try:
            self._run(self.roots[k], self._settings, self.device)
            rec["raw"] = out.read_bytes()
        except Exception as exc:  # a failed call is counted, and fails the check
            rec["error"] = f"{type(exc).__name__}: {exc}"
        return rec

    # ------------------------------------------------------------ what per-layer readers need

    def trace_targets(self) -> List[str]:
        return list(self.mix.get("trace_spans", []))

    def chunks_per_call(self) -> int:
        """Chunk steps of one call at the program's own chunk size."""
        return -(-self.taps // int(self._settings.chunk_taps))

    def padded(self) -> int:
        return tables.padded_length(self.samples_per_tap)

    def kernel_work(self) -> Dict[str, List[dict]]:
        """What one call asks of K1 and K2, however the program splits it
        into launches: K1 the Schroeder curve of every tap's broadband rows
        and of every band's rows, K2 the shared STFT and the modal STFT (cut
        at the last bin a log bin reads) of every tap's rows, all over the
        padded length."""
        rows = self.taps * int(self.config["channels"])
        n = self.padded()
        bands = len(tables.bands_for(self.mix["band_mode"], self.sr))
        _m, _ne, k_out = tables.modal_bins(8192, self.sr)
        return {"k1": [{"rows": rows, "n": n}, {"rows": rows * bands, "n": n}],
                "k2": [{"rows": rows, "n": n, "n_fft": 4096, "hop": 512, "bins": 2049},
                       {"rows": rows, "n": n, "n_fft": 8192, "hop": 512, "bins": k_out}]}

    def counters(self) -> dict:
        from audio_analysis_tpu_torch.engine import graphs

        return dict(graphs.STEP_GRAPHS.stats())

    @staticmethod
    def phases(rec: dict) -> dict:
        return json.loads(rec["raw"])["phases"] if "raw" in rec else {}

    # ------------------------------------------------------------ the check

    def release(self) -> None:
        """Free the program's device state before the reference runs."""
        from audio_analysis_tpu_torch.engine import graphs

        graphs.STEP_GRAPHS.clear()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def reference(self, precision=ref_engine.FLOAT64):
        settings = ref_engine.Settings(sample_rate_hz=self.sr, band_mode=self.mix["band_mode"])
        return ref_engine.Reference(settings, self.samples_per_tap, self.device, precision)

    def judge(self, records: List[dict]) -> Dict[str, object]:
        """Every call's answer for every tap against the reference, and the
        bundle's median T30 over its taps: the widest gap of each family
        over all of them, the taps answered, and the taps that came without
        an answer."""
        ref = self.reference()
        worst = Worst()
        failed = 0
        names = capture.tap_names(self.taps)
        parsed: Dict[int, List[dict]] = {}
        for i, rec in enumerate(records):
            try:
                body = json.loads(rec["raw"])
                if body["taps"] != names:
                    raise ValueError("tap list differs")
                metrics = {k: np.asarray(v, dtype=np.float64) for k, v in body["metrics"].items()}
                if any(v.shape[0] != self.taps for v in metrics.values()):
                    raise ValueError("a metric lacks taps")
                median_t30 = body["bundle_median_t30"]
                parsed.setdefault(rec["input"], []).append((i, metrics, median_t30))
            except (KeyError, ValueError, TypeError):
                failed += rec["ops"]
        for k, calls in parsed.items():
            t30 = []
            for t in range(self.taps):
                r = ref.tap(torch.from_numpy(self.inputs[k][t]))
                t30.append(r["t30_rt60"][r["t30_ok"].astype(bool) & np.isfinite(r["t30_rt60"])])
                for i, metrics, _m in calls:
                    try:
                        prog = {key: v[t] for key, v in metrics.items()}
                        worst.merge(gaps(prog, r, r["fr_mag"], ref.n, self.sr, f"call{i} tap{t}"))
                    except (KeyError, IndexError):
                        worst.add("decay_gap", 1.0, f"call{i} tap{t} missing metric")
            valid = np.concatenate(t30)
            median_r = float(np.median(valid)) if valid.size else None
            for i, _metrics, median_p in calls:
                gap = (0.0 if median_p is None and median_r is None else
                       1.0 if median_p is None or median_r is None else _rel(median_p, median_r, 1e-12))
                worst.add("decay_gap", gap, f"call{i} bundle_median_t30")
        return {"worst": worst, "failed": failed}

    def control(self, precision=ref_engine.BFLOAT16) -> Worst:
        """The reference in lower precision put in the program's place."""
        ref, low = self.reference(), self.reference(precision)
        worst = Worst()
        for k, samples in enumerate(self.inputs):
            for t in range(self.taps):
                tap = torch.from_numpy(samples[t])
                r = ref.tap(tap)
                worst.merge(gaps(low.tap(tap), r, r["fr_mag"], ref.n, self.sr, f"input{k} tap{t}"))
        return worst
