"""
The capture-bundle contract of the C++ recorder (cpp/recorder.hpp):

    <bundle_root>/
      meta.json          {"sample_rate_hz": int, "length_samples": int,
                          "taps": ["name", ...]}
      taps/<name>.wav    stereo PCM16 interleaved

Reading and writing it, and the loaders that feed the engine: every tap
zero-padded to one length N_max (a multiple of `pad_multiple`), planar
(B, C=2, N_max), as float32 or, on the PCM16 fast path, int16 (the engine
scales by 1/32768 on the device).
"""

from __future__ import annotations

import json
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import List, Tuple

import numpy as np

from audio_analysis_tpu_torch.io import native
from audio_analysis_tpu_torch.io.wav import (
    _read_wav_raw,
    duplicate_mono_to_stereo,
    ensure_2d_channel_array,
    load_wav_file,
    read_wav_header_info,
    wav_header_info,
    wav_is_plain_pcm16,
    write_wav_pcm16,
)


@dataclass(frozen=True)
class BundleMeta:
    sample_rate_hz: int
    length_samples: int
    taps: List[str]


def read_bundle_meta(bundle_root: str | Path) -> BundleMeta:
    meta = json.loads((Path(bundle_root) / "meta.json").read_text())
    return BundleMeta(
        sample_rate_hz=int(meta.get("sample_rate_hz", 48000)),
        length_samples=int(meta.get("length_samples", 0)),
        taps=list(meta.get("taps", [])),
    )


def write_bundle(bundle_root: str | Path, taps: dict[str, np.ndarray], sample_rate_hz: int) -> Path:
    """Write a bundle in the recorder's format from (N,) or (N, 2) float32
    taps (mono taps are written as stereo)."""
    bundle_root = Path(bundle_root)
    (bundle_root / "taps").mkdir(parents=True, exist_ok=True)
    length = 0
    for name, data in taps.items():
        stereo = duplicate_mono_to_stereo(ensure_2d_channel_array(np.asarray(data)))
        write_wav_pcm16(bundle_root / "taps" / f"{name}.wav", stereo, sample_rate_hz)
        length = max(length, stereo.shape[0])
    meta = {
        "sample_rate_hz": int(sample_rate_hz),
        "length_samples": int(length),
        "taps": sorted(taps.keys()),
    }
    (bundle_root / "meta.json").write_text(json.dumps(meta, indent=2) + "\n")
    return bundle_root


def materialize_bundle_view(
    wav_paths: List[str | Path],
    bundle_root: str | Path,
    expected_sample_rate_hz: int | None = None,
) -> Path:
    """
    Turn loose WAV files into a bundle view: `bundle_root/meta.json` +
    `bundle_root/taps/<stem>.wav` symlinks to the originals (copies where
    the filesystem refuses symlinks), marked `"view": true` in meta.json.
    Every bundle tool then works on arbitrary IR collections (`bundle
    --no-plots`, `--compare`, `watch`; symlinks stat through to the
    originals, so re-rendering an input re-triggers analysis).

    Tap order is the input order; duplicate stems get `_2`, `_3`...
    suffixes. All inputs must share one sample rate (the engine analyses
    the batch at a single rate; `expected_sample_rate_hz` enforces one).
    A bundle that is not a view is never overwritten, and taps of an
    earlier view that the new input set does not hold are removed.
    """
    paths = [Path(p) for p in wav_paths]
    if not paths:
        raise ValueError("materialize_bundle_view: no input WAV files given")
    for p in paths:
        if not p.is_file():
            raise ValueError(f"Input WAV not found: {p}")

    def probe(path: Path) -> Tuple[int, int]:
        """(frames, sample_rate) without decoding PCM where possible."""
        if native.available():
            frames, _ch, rate = native.read_wav_info(path)
            return int(frames), int(rate)
        info = wav_header_info(path)
        if info is not None:
            frames, _ch, rate = info
            return int(frames), int(rate)
        # unparseable header: the decoder gives its error (or reads an
        # exotic but valid file the header walk refused)
        rate, raw = _read_wav_raw(path)
        return int(np.asarray(raw).shape[0]), int(rate)

    frames_rates = [probe(p) for p in paths]
    rates = {rate for _f, rate in frames_rates}
    if len(rates) > 1:
        raise ValueError(
            f"Inputs mix sample rates {sorted(rates)} — the engine analyses "
            "one batch at one rate; split the files by rate"
        )
    rate = rates.pop()
    if expected_sample_rate_hz is not None and rate != int(expected_sample_rate_hz):
        raise ValueError(
            f"Inputs are {rate} Hz, expected {int(expected_sample_rate_hz)} Hz"
        )

    names: List[str] = []
    used = set()
    for p in paths:
        name = p.stem
        k = 2
        while name in used:
            name = f"{p.stem}_{k}"
            k += 1
        used.add(name)
        names.append(name)

    bundle_root = Path(bundle_root)
    meta_path = bundle_root / "meta.json"
    if meta_path.is_file():
        try:
            existing = json.loads(meta_path.read_text())
        except (OSError, ValueError):
            existing = None
        if not (isinstance(existing, dict) and existing.get("view")):
            raise ValueError(
                f"{bundle_root} already holds a bundle that is not a batch "
                "view - refusing to overwrite it; choose an empty --output"
            )
    taps_dir = bundle_root / "taps"
    taps_dir.mkdir(parents=True, exist_ok=True)
    for name, src in zip(names, paths):
        dst = taps_dir / f"{name}.wav"
        target = src.resolve()
        if dst.is_symlink() or dst.exists():
            if dst.is_symlink() and dst.resolve() == target:
                continue  # already points at this input
            dst.unlink()
        try:
            dst.symlink_to(target)
        except OSError:
            shutil.copyfile(target, dst)

    # a stale taps/<x>.wav that meta.json no longer lists would read as a
    # phantom tap to anything globbing the directory
    keep = {f"{name}.wav" for name in names}
    for leftover in taps_dir.glob("*.wav"):
        if leftover.name not in keep:
            leftover.unlink()

    meta = {
        "sample_rate_hz": int(rate),
        "length_samples": int(max(f for f, _r in frames_rates)),
        "taps": names,
        "view": True,
    }
    meta_path.write_text(json.dumps(meta, indent=2) + "\n")
    return bundle_root


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _tap_paths(bundle_root: Path, meta: BundleMeta) -> List[Path]:
    return [bundle_root / "taps" / f"{t}.wav" for t in meta.taps]


def _probe_lengths(paths: List[Path], meta: BundleMeta, pad_multiple: int) -> Tuple[List[int], int]:
    """Every tap's frame count from its header (the native probe, else the
    header parser), checked against the bundle's rate, and the padded
    length N_max."""
    probe = native.read_wav_info if native.available() else read_wav_header_info
    lengths = []
    for p in paths:
        frames, _, rate = probe(p)
        if rate != meta.sample_rate_hz:
            raise ValueError(f"Tap {p} sample rate {rate} != bundle {meta.sample_rate_hz}")
        lengths.append(frames)
    return lengths, _round_up(max(lengths) if lengths else pad_multiple, pad_multiple)


def load_bundle_batch(
    bundle_root: str | Path, pad_multiple: int = 4096, num_threads: int = 8
) -> Tuple[BundleMeta, np.ndarray, np.ndarray, List[str]]:
    """(meta, (B, C=2, N_max) float32 batch zero-padded past each tap's
    length, (B,) int32 lengths, tap names in batch order)."""
    bundle_root = Path(bundle_root)
    meta = read_bundle_meta(bundle_root)
    paths = _tap_paths(bundle_root, meta)
    if native.available():
        _lengths, n_max = _probe_lengths(paths, meta, pad_multiple)
        interleaved, length_arr = native.read_bundle(paths, n_max, 2, num_threads)
        batch = np.ascontiguousarray(np.transpose(interleaved, (0, 2, 1)))
        return meta, batch, length_arr.astype(np.int32), meta.taps
    loaded = [load_wav_file(p, meta.sample_rate_hz) for p in paths]
    lengths = np.array([a.samples.shape[0] for a in loaded], dtype=np.int32)
    n_max = _round_up(int(lengths.max()) if len(loaded) else pad_multiple, pad_multiple)
    batch = np.zeros((len(loaded), 2, n_max), dtype=np.float32)
    for i, a in enumerate(loaded):
        batch[i, :, : a.samples.shape[0]] = a.samples.T
    return meta, batch, lengths, meta.taps


def load_bundle_batch_i16(bundle_root: str | Path, pad_multiple: int = 4096, num_threads: int = 8):
    """PCM16 fast path: (meta, (B, C=2, N_max) int16 batch, (B,) int32
    lengths, names), no float conversion on the host. None when the native
    library is missing or any tap is not plain PCM16."""
    if not native.available():
        return None
    bundle_root = Path(bundle_root)
    meta = read_bundle_meta(bundle_root)
    paths = _tap_paths(bundle_root, meta)
    _lengths, n_max = _probe_lengths(paths, meta, pad_multiple)
    result = native.read_bundle_planar_i16(paths, n_max, 2, num_threads)
    if result is None:
        return None
    batch_i16, length_arr = result
    return meta, batch_i16, length_arr.astype(np.int32), meta.taps


def open_bundle_chunks_i16(bundle_root: str | Path, pad_multiple: int = 4096, num_threads: int = 8):
    """Chunked PCM16 fast path for pipelined decode: (meta, (B,) int32
    lengths, names, n_max, loader), where loader(lo, hi) decodes taps
    [lo, hi) into a planar (hi-lo, 2, n_max) int16 chunk. Every tap's
    header is probed and vetted as plain PCM16 up front, so the padded
    shape is fixed and loader() cannot fail on format mid-pipeline. None
    when the native library is missing or any tap is not plain PCM16."""
    if not native.available():
        return None
    bundle_root = Path(bundle_root)
    meta = read_bundle_meta(bundle_root)
    paths = _tap_paths(bundle_root, meta)
    lengths, n_max = _probe_lengths(paths, meta, pad_multiple)

    def loader(lo: int, hi: int):
        result = native.read_bundle_planar_i16(paths[lo:hi], n_max, 2, num_threads)
        if result is None:
            raise IOError(f"Bundle taps [{lo}:{hi}) are not plain PCM16; use load_bundle_batch instead")
        return result[0]

    if not all(wav_is_plain_pcm16(p) for p in paths):
        return None
    return meta, np.asarray(lengths, np.int32), meta.taps, n_max, loader


def open_bundle_chunks(bundle_root: str | Path, pad_multiple: int = 4096, num_threads: int = 8):
    """Chunked decode of any bundle, as open_bundle_chunks_i16: the PCM16
    fast path where it applies, else a loader(lo, hi) of planar
    (hi-lo, 2, n_max) float32 chunks, mono taps upmixed. Every tap's
    header is probed and its rate checked up front, with or without the
    native library."""
    chunked = open_bundle_chunks_i16(bundle_root, pad_multiple, num_threads)
    if chunked is not None:
        return chunked
    bundle_root = Path(bundle_root)
    meta = read_bundle_meta(bundle_root)
    paths = _tap_paths(bundle_root, meta)
    lengths, n_max = _probe_lengths(paths, meta, pad_multiple)

    def loader(lo: int, hi: int):
        if native.available():
            interleaved, _ = native.read_bundle(paths[lo:hi], n_max, 2, num_threads)
            return np.ascontiguousarray(np.transpose(interleaved, (0, 2, 1)))
        chunk = np.zeros((hi - lo, 2, n_max), np.float32)
        for row, p in enumerate(paths[lo:hi]):
            samples = load_wav_file(p, meta.sample_rate_hz).samples
            chunk[row, :, : samples.shape[0]] = samples.T
        return chunk

    return meta, np.asarray(lengths, np.int32), meta.taps, n_max, loader
