"""
Engine-backed bundle reports (audio_analysis_tpu/report/engine_report.py):
decode every tap, run the fused engine over the bundle in chunks, and write
per-tap markdown summaries (the deterministic text formats of the plot
reports, minus the images) plus a machine-readable bundle_metrics.json.

The run's `device` decides between one device and a mesh of devices
(engine.mesh), as the JAX package's `use_device_mesh="auto"` does: the
bare `cuda` with more than one CUDA device visible shards the tap batch
over every one of them; an explicit device (`cuda:1`, `cpu`) means that
one device.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from audio_analysis_tpu_torch.engine.batch import (
    analyze_bundle,
    analyze_bundle_pipelined,
    band_names,
)
from audio_analysis_tpu_torch.engine.config import EngineConfig
from audio_analysis_tpu_torch.engine.mesh import Mesh, make_mesh
from audio_analysis_tpu_torch.io import (
    load_bundle_batch,
    load_bundle_batch_i16,
    open_bundle_chunks_i16,
)
from audio_analysis_tpu_torch.ops import stft as stft_ops
from audio_analysis_tpu_torch.report.compare import compare_section_for_index
from audio_analysis_tpu_torch.report.waterfall import (
    WaterfallAnalysisSettings,
    select_slice_frame_indices,
)
from audio_analysis_tpu_torch.utils.timing import span


@dataclass(frozen=True)
class EngineBundleSettings:
    reports_subdir: str = "reports"
    use_mono_downmix_for_stereo: bool = False
    config: EngineConfig = EngineConfig()
    # taps per chunk: the three-band filterbank plane and the modal
    # 8192-point STFT plane are the largest intermediates of a chunk
    chunk_taps: int = 8
    # chunks decoded + uploaded ahead of the one being computed
    prefetch_chunks: int = 2
    # keep the padded int16 tap audio on the device between runs of the
    # same unchanged bundle (keyed per chunk by tap path + mtime + size,
    # and by the device or mesh), so a warm rerun skips decode and upload
    cache_device_audio: bool = True
    # a previous run's bundle_metrics.json (or its reports dir, or bundle
    # root): append a "Changes vs ..." section to the index flagging the
    # headline metrics that moved by at least the threshold (report/compare.py)
    compare_to: Optional[str] = None
    compare_threshold_pct: float = 1.0


def _engine_mesh(device: torch.device) -> Optional[Mesh]:
    """The mesh of a run, or None for the one `device` (module docstring)."""
    if device.type != "cuda" or device.index is not None or torch.cuda.device_count() <= 1:
        return None
    return make_mesh()


def _channel_names_from_output(out: Dict[str, np.ndarray]) -> List[str]:
    """Channel labels matching the engine output's channel axis."""
    c = int(np.asarray(out["start_index"]).shape[1])
    if c == 1:
        return ["mono"]
    if c == 2:
        return ["left", "right"]
    return [f"ch{i}" for i in range(c)]


def _fit_line(
    out: Dict[str, np.ndarray], name: str, b: int, c: int, ranges: tuple
) -> str:
    """One decay-fit summary line in the decay.py:530-538 format, printing
    the configured dB window."""
    label = name.upper()
    if not bool(out[f"{name}_ok"][b, c]):
        return f"  {label}: NA"
    return (
        f"  {label}: "
        f"range=[{ranges[0]:.1f},{ranges[1]:.1f}]dB "
        f"time=[{out[f'{name}_t_start'][b, c]:.4f},{out[f'{name}_t_end'][b, c]:.4f}]s "
        f"slope={out[f'{name}_slope'][b, c]:.6f}dB/s "
        f"r2={out[f'{name}_r2'][b, c]:.6f} "
        f"rt60={out[f'{name}_rt60'][b, c]:.4f}s"
    )


def _summary_context(config: EngineConfig, sample_rate_hz: int) -> Dict:
    """Per-bundle constants for format_tap_summary, computed once."""
    wf_settings = WaterfallAnalysisSettings()
    freq_hz = stft_ops.rfft_freqs_hz(config.n_fft, sample_rate_hz)
    return {
        "band_labels": band_names(config),
        "fit_ranges": {
            "edt": config.edt_range_db,
            "t20": config.t20_range_db,
            "t30": config.t30_range_db,
        },
        "wf_settings": wf_settings,
        "wf_select": select_slice_frame_indices,
        "wf_f_bins": int(
            ((freq_hz >= wf_settings.f_min_hz) & (freq_hz <= wf_settings.f_max_hz)).sum()
        ),
        "frame_times": stft_ops.frame_times_seconds,
    }


def format_tap_summary(
    out: Dict[str, np.ndarray],
    b: int,
    channel_names: List[str],
    sample_rate_hz: int,
    config: EngineConfig,
    ctx: Optional[Dict] = None,
) -> str:
    """All per-tap deterministic summaries in the reference text formats."""
    if ctx is None:
        ctx = _summary_context(config, sample_rate_hz)
    md: List[str] = []

    if "peak_abs" in out:
        md.append("## Impulse response\n\n```text")
        for c, ch in enumerate(channel_names):
            seg = int(out["segment_length"][b, c])
            md.append(
                f"[{ch}] peak_sample={int(out['start_index'][b, c])}  "
                f"peak_abs={out['peak_abs'][b, c]:.6f}  "
                f"dur={seg / sample_rate_hz:.3f}s"
            )
        md.append("```\n")

    md.append("## Decay / EDC\n\n```text")
    for c, ch in enumerate(channel_names):
        md.append(f"[{ch}] analysis_start_sample_index={int(out['start_index'][b, c])}")
        if bool(out["early10_ok"][b, c]):
            md.append(f"  early_0_to_-10_time={out['early10_time'][b, c]:.4f}s")
        else:
            md.append("  early_0_to_-10_time=NA")
        for name in ("edt", "t20", "t30"):
            md.append(_fit_line(out, name, b, c, ctx["fit_ranges"][name]))
        md.append("")
    md.append("```\n")

    if "band_t30_rt60" in out:
        labels = ctx["band_labels"]
        md.append("## RT60 by band\n\n```text")
        for c, ch in enumerate(channel_names):
            md.append(f"[{ch}]")
            md.append("Band  T30_RT60(s)")
            for bi, band in enumerate(labels):
                ok = bool(out["band_t30_ok"][b, c, bi])
                value = f"{out['band_t30_rt60'][b, c, bi]:.3f}" if ok else "NA"
                md.append(f"{band}  {value}")
            md.append("")
        md.append("```\n")

    if "fr_peak_hz" in out:
        md.append("## Frequency response\n\n```text")
        for c, ch in enumerate(channel_names):
            md.append(
                f"[{ch}] start_sample={int(out['start_index'][b, c])}  "
                f"len_samples={int(out['segment_length'][b, c])}  "
                f"peak={out['fr_peak_hz'][b, c]:.1f}Hz  "
                f"centroid={out['fr_centroid_hz'][b, c]:.1f}Hz"
            )
        md.append("```\n")

    if "gd_median" in out:
        md.append("## Group delay\n\n```text\nGroup delay summary:")
        for c, ch in enumerate(channel_names):
            md.append(
                f"- {ch}: gd median={out['gd_median'][b, c]:.3f} samples, "
                f"p10={out['gd_p10'][b, c]:.3f}, p90={out['gd_p90'][b, c]:.3f}"
            )
        md.append("```\n")

    if "stft_num_frames" in out:
        md.append("## Spectrogram\n\n```text")
        for c, ch in enumerate(channel_names):
            seg = int(out["segment_length"][b, c])
            md.append(
                f"[{ch}] start_sample={int(out['start_index'][b, c])}  "
                f"len_samples={seg}  dur={seg / sample_rate_hz:.3f}s  "
                f"stft(n_fft={config.n_fft}, frames={int(out['stft_num_frames'][b, c])})"
            )
        md.append("```\n")

        # waterfall summary derived from the shared STFT (auto mode, 18
        # slices, 20-20k display band)
        f_bins = ctx["wf_f_bins"]
        md.append("## Waterfall\n\n```text")
        for c, ch in enumerate(channel_names):
            t_frames = int(out["stft_num_frames"][b, c])
            times = ctx["frame_times"](t_frames, config.hop_length, sample_rate_hz)
            slices = ctx["wf_select"](times, ctx["wf_settings"]).size
            seg = int(out["segment_length"][b, c])
            md.append(
                f"[{ch}] start_sample={int(out['start_index'][b, c])}  "
                f"dur={seg / sample_rate_hz:.3f}s  "
                f"slices={slices}  f_bins={f_bins}"
            )
        md.append("```\n")

    if "diff_median_autocorr" in out:
        md.append("## Diffusion / echo density proxy\n\n```text")
        for c, ch in enumerate(channel_names):
            md.append(f"[{ch}]")
            md.append(f"  median_max_abs_autocorr={out['diff_median_autocorr'][b, c]:.3f}")
            md.append(f"  median_echo_density={out['diff_median_echo_density'][b, c]:.3f}")
            # stereo-only metrics exist only when the engine ran on C == 2
            if "diff_median_corr0" in out:
                md.append(f"  median_corr0={out['diff_median_corr0'][b]:.3f}")
                md.append(f"  median_iacc_max={out['diff_median_iacc'][b]:.3f}")
        md.append("```\n")

    if "modal_count" in out:
        md.append("## Modal cloud\n\n```text")
        for c, ch in enumerate(channel_names):
            seg = int(out["segment_length"][b, c])
            md.append(
                f"[{ch}] metric=t30 start_sample={int(out['start_index'][b, c])} "
                f"dur={seg / sample_rate_hz:.3f}s points={int(out['modal_count'][b, c])}"
            )
            if int(out["modal_count"][b, c]) > 0:
                md.append(
                    f"  rt60: median={out['modal_median_rt60'][b, c]:.3f}s  "
                    f"p90={out['modal_p90_rt60'][b, c]:.3f}s  "
                    f"max={out['modal_max_rt60'][b, c]:.3f}s"
                )
        md.append("```\n")

    return "\n".join(md)


# single-slot (one bundle) device-resident tap-audio cache, keyed per
# chunk: re-analysing a bundle re-decodes and re-uploads only the chunks
# whose tap WAVs changed
_DEVICE_AUDIO_CACHE: Dict = {"shape_key": None, "entries": {}}


class _ChunkCache:
    """Per-chunk get/put view over _DEVICE_AUDIO_CACHE for one bundle run.

    Each entry is (chunk_signature, the chunk's per-shard device tensors),
    the signature being the (path, mtime_ns, size) tuples of exactly the
    taps in that chunk. Entries of the previous run are popped as they are
    consulted, so a replaced chunk's device buffer is released before its
    successor uploads."""

    def __init__(self, sig_for: list, chunk_taps: int, old: Dict, new: Dict):
        self._sig_for = sig_for
        self._chunk = int(chunk_taps)
        self._old = old
        self._new = new
        self.reused = 0
        self.uploaded = 0

    def _sig(self, idx: int):
        lo = idx * self._chunk
        return tuple(self._sig_for[lo : lo + self._chunk])

    def get(self, idx: int):
        ent = self._old.pop(idx, None)
        if ent is not None and ent[0] == self._sig(idx):
            self._new[idx] = ent
            self.reused += 1
            return ent[1]
        return None

    def put(self, idx: int, arr) -> None:
        self._new[idx] = (self._sig(idx), arr)
        self.uploaded += 1


def _device_audio_chunks(
    bundle_root: Path,
    names: List[str],
    chunk_taps: int,
    n_max: int,
    device: torch.device,
    mesh: Optional[Mesh] = None,
) -> _ChunkCache:
    """A per-chunk cache view for this bundle state. Chunks whose taps'
    path/mtime/size are unchanged, at the same chunking, padded length and
    device (or mesh), are served from device memory. A chunk is chunk_taps
    taps per shard, clamped for a small bundle as analyze_bundle_pipelined
    clamps it; a single-device entry never serves a mesh run, nor a mesh
    entry a single-device run."""
    sig_for = []
    for tap in names:
        p = bundle_root / "taps" / f"{tap}.wav"
        st = os.stat(p)
        sig_for.append((str(p), st.st_mtime_ns, st.st_size))

    shards = len(mesh) if mesh is not None else 1
    eff_chunk = max(1, min(int(chunk_taps), -(-len(names) // shards))) * shards
    placement = ("device", str(device)) if mesh is None else ("mesh", tuple(str(d) for d in mesh))
    cache = _DEVICE_AUDIO_CACHE
    shape_key = (eff_chunk, int(n_max), placement)
    if cache["shape_key"] != shape_key:
        cache["shape_key"] = shape_key
        cache["entries"] = {}
    old = cache["entries"]
    new: Dict = {}
    cache["entries"] = new
    return _ChunkCache(sig_for, eff_chunk, old, new)


def run_bundle_report_engine(
    bundle_root: str | Path,
    settings: Optional[EngineBundleSettings] = None,
    device: "str | torch.device" = "cuda",
) -> Path:
    """Fused-engine bundle analysis on `device`: per-tap summary md +
    bundle_metrics.json. Returns the path of the index markdown. The call
    is the span `aa.bundle`, its stretches named spans within it
    (utils/timing.py lists them)."""
    with span("aa.bundle"):
        # the span aa.report.tail, from the last chunk's fetch to the return
        tail: Dict = {}
        try:
            return _bundle_report(bundle_root, settings, device, tail)
        finally:
            if "span" in tail:
                tail["span"].__exit__(None, None, None)


class _MetricsJson:
    """bundle_metrics.json's "metrics" object, encoded a chunk at a time as
    its results arrive: each key's rows joined in tap order give the bytes
    that json.dumps(..., separators=(",", ":")) gives the whole
    {key: array.tolist()} dict, NaN and Infinity included."""

    def __init__(self) -> None:
        self._rows: Dict[str, List[str]] = {}

    def add(self, res: Dict[str, np.ndarray]) -> None:
        for key, value in res.items():
            # the chunk's list without its brackets: its taps' rows
            self._rows.setdefault(key, []).append(json.dumps(np.asarray(value).tolist(), separators=(",", ":"))[1:-1])

    def dumps(self, head: Dict) -> str:
        """The file: `head`'s keys, then "metrics" last."""
        text = json.dumps(dict(head, metrics=0), separators=(",", ":"))
        assert text.endswith(',"metrics":0}')
        body = ",".join(f"{json.dumps(key)}:[{','.join(rows)}]" for key, rows in self._rows.items())
        return text[: -len("0}")] + "{" + body + "}}"


def _bundle_report(bundle_root, settings: Optional[EngineBundleSettings], device, tail: Dict) -> Path:
    if settings is None:
        settings = EngineBundleSettings()
    device = torch.device(device)

    bundle_root = Path(bundle_root)
    if not (bundle_root / "meta.json").exists():
        raise ValueError(
            f"Not a capture bundle: {bundle_root} has no meta.json "
            "(expected the recorder layout: meta.json + taps/*.wav)"
        )
    # unrounded seconds of the spans that feed phases
    timed: Dict[str, float] = {}

    # PCM16 fast path: int16 decoded chunk by chunk on a worker thread,
    # planar from the native decoder for mono and stereo, interleaved (the
    # data chunks as they are) for C > 2; float conversion, the channel
    # split and the mono downmix happen on the device. Otherwise the whole
    # bundle decodes up front.
    with span("aa.bundle.probe", timed, "probe_s"):
        chunked = open_bundle_chunks_i16(bundle_root)
        if chunked is not None:
            meta, lengths, names, n_max, loader = chunked
            batch = None
            downmix_on_device = settings.use_mono_downmix_for_stereo
            channels = loader.channels
        else:
            fast = load_bundle_batch_i16(bundle_root)
            if fast is not None:
                meta, batch, lengths, names = fast
                downmix_on_device = settings.use_mono_downmix_for_stereo
                channels = batch.shape[1]
            else:
                meta, batch, lengths, names = load_bundle_batch(bundle_root)
                downmix_on_device = False
                channels = batch.shape[1]
                if settings.use_mono_downmix_for_stereo and channels == 2:
                    batch = np.mean(batch, axis=1, keepdims=True).astype(np.float32)
    load_seconds = timed["probe_s"]
    if len(names) == 0:
        raise ValueError(f"Bundle {bundle_root} has no taps.")
    if settings.use_mono_downmix_for_stereo and channels > 2:
        raise ValueError(
            f"The stereo downmix (--mono) needs mono or stereo taps; {bundle_root} has {channels} channels a tap")

    config = settings.config
    if config.sample_rate_hz != meta.sample_rate_hz:
        config = replace(config, sample_rate_hz=meta.sample_rate_hz)
    if downmix_on_device and not config.downmix_to_mono:
        config = replace(config, downmix_to_mono=True)

    reports_root = bundle_root / settings.reports_subdir
    tap_lines: List[str] = []
    metrics_text = _MetricsJson()

    def _write_tap(tap: str, b_global: int, out_like: Dict, b_local: int,
                   channel_names: List[str]) -> None:
        out_dir = reports_root / tap
        out_dir.mkdir(parents=True, exist_ok=True)
        body = format_tap_summary(
            out_like, b_local, channel_names, meta.sample_rate_hz, config, ctx
        )
        header = (
            "# Offline Reverb Analysis Report (engine)\n\n"
            f"**Tap:** `{tap}`  \n"
            f"**Sample rate:** {meta.sample_rate_hz} Hz  \n"
            f"**Samples:** {int(lengths[b_global])}\n\n---\n\n"
        )
        (out_dir / f"{tap}_report.md").write_text(header + body)
        tap_lines.append(f"- [{tap}]({tap}/{tap}_report.md)")

    def _on_chunk(lo: int, hi: int, res: Dict) -> None:
        # chunk k's summaries and its part of bundle_metrics.json are done
        # while later chunks still compute; what the last chunk's leaves is
        # the call's tail
        if hi == len(names):
            tail["span"] = span("aa.report.tail").__enter__()
            tail["t0"] = time.perf_counter()
        with span("aa.report.markdown"):
            ch_names = _channel_names_from_output(res)
            for b in range(lo, hi):
                _write_tap(names[b], b, res, b - lo, ch_names)
        with span("aa.report.json_encode"):
            metrics_text.add(res)

    phases: Dict[str, float] = {"probe_s": round(load_seconds, 4)}
    with span("aa.bundle.prepare"):
        reports_root.mkdir(parents=True, exist_ok=True)
        ctx = _summary_context(config, meta.sample_rate_hz)
        start_compute = time.perf_counter()
        mesh = _engine_mesh(device)
        chunk_cache = None
        if batch is None and settings.cache_device_audio:
            chunk_cache = _device_audio_chunks(
                bundle_root, names, settings.chunk_taps, n_max, device, mesh
            )
    if batch is None:
        out = analyze_bundle_pipelined(
            loader, lengths, n_max, config, settings.chunk_taps, mesh=mesh,
            timings=phases, device_chunk_cache=chunk_cache,
            prefetch_chunks=settings.prefetch_chunks,
            on_chunk_result=_on_chunk, device=device,
        )
        if chunk_cache is not None:
            phases["audio_chunks_reused"] = chunk_cache.reused
            phases["audio_chunks_uploaded"] = chunk_cache.uploaded
        phases["markdown_s"] = phases.pop("chunk_callback_s", 0.0)
    else:
        out = analyze_bundle(batch, lengths, config, settings.chunk_taps, device, mesh=mesh)
    compute_seconds = time.perf_counter() - start_compute
    phases["compute_total_s"] = round(compute_seconds, 4)

    # channel names follow the engine's actual channel count
    channel_names = _channel_names_from_output(out)

    if batch is not None:
        tail["span"] = span("aa.report.tail").__enter__()
        tail["t0"] = time.perf_counter()
        with span("aa.report.markdown", timed, "markdown_s"):
            for b, tap in enumerate(names):
                _write_tap(tap, b, out, b, channel_names)
            metrics_text.add(out)
        phases["markdown_s"] = round(timed["markdown_s"], 4)

    # machine-readable dump of every metric
    with span("aa.report.json_build", timed, "json_s"):
        t30 = np.asarray(out["t30_rt60"])
        t30_valid = t30[np.asarray(out["t30_ok"]) & np.isfinite(t30)]
        head = {
            "taps": names,
            "channels": channel_names,
            "load_seconds": load_seconds,
            "compute_seconds": compute_seconds,
            "bundle_median_t30": float(np.median(t30_valid)) if t30_valid.size else None,
            "phases": phases,  # json_s (and tail_s) land in the file too (dict aliased)
        }
        # the previous run's file is read before this run's dump overwrites
        # it, so comparing against the same reports dir in place works
        compare_section = None
        if settings.compare_to:
            compare_section = compare_section_for_index(
                dict(head, metrics={k: np.asarray(v).tolist() for k, v in out.items()}),
                settings.compare_to, settings.compare_threshold_pct,
            )
    # json_s times building the head and the compare; the join and both
    # writes are the span aa.report.write, in no phase; a bundle of C > 2
    # channels also gets tail_s, the tail up to that span
    phases["json_s"] = round(timed["json_s"], 4)
    if channels > 2:
        phases["tail_s"] = round(time.perf_counter() - tail["t0"], 4)
    with span("aa.report.write"):
        # compact separators keep CPython's C encoder
        (reports_root / "bundle_metrics.json").write_text(metrics_text.dumps(head))
        del metrics_text  # the encoded rows are freed inside this span, not on return
        index_lines = [
            "# IR Bundle Report (engine)\n",
            f"**Bundle:** `{bundle_root}`\n",
            f"**Sample rate:** {meta.sample_rate_hz}\n",
            f"**Length (samples):** {meta.length_samples}\n",
            f"**Taps:** {len(names)}  |  load {load_seconds:.3f}s  |  "
            f"analysis {compute_seconds:.3f}s\n",
            "\n## Taps\n",
        ] + tap_lines
        if compare_section:
            index_lines.append(compare_section)
        index_path = reports_root / "bundle_report.md"
        index_path.write_text("\n".join(index_lines) + "\n")
    return index_path
