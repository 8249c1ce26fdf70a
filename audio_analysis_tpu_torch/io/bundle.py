"""
The capture-bundle contract (the C++ recorder, cpp/recorder.hpp, writes
stereo bundles of it):

    <bundle_root>/
      meta.json          {"sample_rate_hz": int, "length_samples": int,
                          "taps": ["name", ...]}
      taps/<name>.wav    PCM16 interleaved, C channels, the same C in
                         every tap: mono or stereo (C <= 2), or C > 2
                         (third-order AmbiX, ACN order and SN3D, is 16)

The channel count comes from the taps' headers. Mono and stereo taps may
mix (a mono tap is upmixed to both channels); taps with C > 2 must all
have the same C, and any other mix raises ValueError naming the tap.

Reading and writing it, and the loaders that feed the engine: every tap
zero-padded to one length N_max (a multiple of `pad_multiple`), planar
(B, C, N_max) float32, or, on the PCM16 fast path, int16 with no float
conversion on the host (the engine scales by 1/32768 on the device). The
chunked PCM16 loader of a bundle of C > 2 channels gives interleaved
(B, N_max, C) chunks instead, each tap's data chunk copied as it is, and
the engine splits the channels on the device (engine.batch).
"""

from __future__ import annotations

import json
import os
import shutil
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import List, Tuple

import numpy as np

from audio_analysis_tpu_torch.io import native
from audio_analysis_tpu_torch.io.wav import (
    _read_wav_raw,
    convert_wav_samples_to_float32,
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


def bundle_channels(paths: List[Path], channels: List[int]) -> int:
    """The channels a bundle's taps load with: 2 where every tap is mono or
    stereo, C where every tap has the same C > 2. Any other mix raises
    ValueError naming the first tap that differs and its count."""
    if all(c <= 2 for c in channels):
        return 2
    first = next(i for i, c in enumerate(channels) if c > 2)
    for p, c in zip(paths, channels):
        if c != channels[first]:
            raise ValueError(
                f"Tap {p} has {c} channel(s), but tap {paths[first]} has {channels[first]}: every tap of a "
                f"bundle of more than two channels must have the same count")
    return channels[first]


def _probe_taps(paths: List[Path], meta: BundleMeta, pad_multiple: int) -> Tuple[List[int], int, int]:
    """Every tap's frame count and channel count from its header (the
    native probe, else the header parser), checked against the bundle's
    rate: (lengths, the padded length N_max, the bundle's channels)."""
    probe = native.read_wav_info if native.available() else read_wav_header_info
    lengths, channels = [], []
    for p in paths:
        frames, ch, rate = probe(p)
        if rate != meta.sample_rate_hz:
            raise ValueError(f"Tap {p} sample rate {rate} != bundle {meta.sample_rate_hz}")
        lengths.append(frames)
        channels.append(int(ch))
    n_max = _round_up(max(lengths) if lengths else pad_multiple, pad_multiple)
    return lengths, n_max, bundle_channels(paths, channels)


def _decode_f32(paths: List[Path], sample_rate_hz: int, channels: int, n_max: int, num_threads: int) -> np.ndarray:
    """Taps decoded to float32, planar (B, C, n_max), mono upmixed where
    C = 2."""
    if native.available():
        interleaved, _ = native.read_bundle(paths, n_max, channels, num_threads)
        return np.ascontiguousarray(np.transpose(interleaved, (0, 2, 1)))
    out = np.zeros((len(paths), channels, n_max), np.float32)
    for row, p in enumerate(paths):
        if channels == 2:
            samples = load_wav_file(p, sample_rate_hz).samples
        else:
            rate, raw = _read_wav_raw(p)
            if rate != sample_rate_hz:
                raise ValueError(f"Tap {p} sample rate {rate} != bundle {sample_rate_hz}")
            samples = ensure_2d_channel_array(convert_wav_samples_to_float32(raw))
        out[row, :, : samples.shape[0]] = samples.T
    return out


def _pcm16_data(path: Path) -> Tuple[int, int, int]:
    """(byte offset of the data chunk's samples, frames, channels) of a
    plain PCM16 WAV (WAVE_FORMAT_EXTENSIBLE with a PCM GUID included),
    from its header; ValueError for any other file."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"Not a RIFF/WAVE file: {path}")
        channels = 0
        while True:
            header = f.read(8)
            if len(header) < 8:
                raise ValueError(f"No data chunk found in {path}")
            chunk_id, size = header[:4], struct.unpack("<I", header[4:])[0]
            if chunk_id == b"fmt ":
                fmt = f.read(size + (size & 1)) if 16 <= size <= 65536 else b""
                if len(fmt) < 16:
                    raise ValueError(f"Malformed fmt chunk in {path}")
                tag, channels = struct.unpack("<HH", fmt[:4])
                (bits,) = struct.unpack("<H", fmt[14:16])
                if tag == 0xFFFE and len(fmt) >= 26:
                    (tag,) = struct.unpack("<H", fmt[24:26])
                if tag != 1 or bits != 16 or not channels:
                    raise ValueError(f"Tap {path} is not PCM16")
            elif chunk_id == b"data":
                if not channels:
                    raise ValueError(f"data chunk before fmt in {path}")
                return f.tell(), size // (2 * channels), channels
            else:
                f.seek(size + (size & 1), 1)


def read_interleaved_i16(
    paths: List[Path], n_max: int, channels: int, out: np.ndarray | None = None
) -> np.ndarray:
    """PCM16 taps of `channels` interleaved channels, each tap's data chunk
    copied as it is into its row of `out`, a C-contiguous (len(paths),
    n_max, channels) int16 buffer (a new one when None), zero past the
    tap's frames, so a buffer can be reused. Returns `out`; ValueError for
    a tap that is not PCM16 or has another channel count.

    One `preadv` a tap, one tap after another on the calling thread: the
    call releases the interpreter lock for the whole copy, while a pool of
    reading threads would take the lock from the thread that drives the
    device at every hand-off."""
    shape = (len(paths), int(n_max), int(channels))
    if out is None:
        out = np.empty(shape, np.int16)
    if out.shape != shape or out.dtype != np.int16 or not out.flags.c_contiguous:
        raise ValueError(f"read_interleaved_i16: out must be C-contiguous int16 {shape}, not {out.dtype} {out.shape}")
    for row, path in enumerate(paths):
        offset, frames, ch = _pcm16_data(path)
        if ch != channels:
            raise ValueError(f"Tap {path} has {ch} channel(s), not {channels}")
        frames = min(frames, shape[1])
        dst = memoryview(out[row]).cast("B")[: frames * channels * 2]
        fd = os.open(path, os.O_RDONLY)
        try:
            done = 0
            while done < len(dst):
                got = os.preadv(fd, [dst[done:]], offset + done)
                if not got:
                    raise IOError(f"Tap {path} ends inside its data chunk")
                done += got
        finally:
            os.close(fd)
        out[row, frames:] = 0
    return out


class ChunkLoader:
    """`loader(lo, hi)`: taps [lo, hi) of a bundle as one chunk. `channels`
    is the bundle's C. With `interleaved` (PCM16, C > 2) the chunk is
    (hi-lo, n_max, C) int16, each tap's data copied as it is into `out`
    (`loader(lo, hi, out)`, a C-contiguous buffer the caller may reuse;
    a new one when None); otherwise a planar (hi-lo, C, n_max) chunk."""

    def __init__(self, read, channels: int, interleaved: bool) -> None:
        self._read = read
        self.channels = channels
        self.interleaved = interleaved

    def __call__(self, lo: int, hi: int, out: np.ndarray | None = None) -> np.ndarray:
        if out is not None and not self.interleaved:
            raise ValueError("a planar loader fills no buffer of the caller's")
        return self._read(lo, hi, out) if self.interleaved else self._read(lo, hi)


def load_bundle_batch(
    bundle_root: str | Path, pad_multiple: int = 4096, num_threads: int = 8
) -> Tuple[BundleMeta, np.ndarray, np.ndarray, List[str]]:
    """(meta, (B, C, N_max) float32 batch zero-padded past each tap's
    length, (B,) int32 lengths, tap names in batch order): C = 2 for a
    mono or stereo bundle, the taps' count above that."""
    bundle_root = Path(bundle_root)
    meta = read_bundle_meta(bundle_root)
    paths = _tap_paths(bundle_root, meta)
    lengths, n_max, channels = _probe_taps(paths, meta, pad_multiple)
    batch = _decode_f32(paths, meta.sample_rate_hz, channels, n_max, num_threads)
    return meta, batch, np.asarray(lengths, np.int32), meta.taps


def load_bundle_batch_i16(bundle_root: str | Path, pad_multiple: int = 4096, num_threads: int = 8):
    """PCM16 fast path: (meta, planar (B, C, N_max) int16 batch, (B,) int32
    lengths, names), no float conversion on the host; C = 2 for a mono or
    stereo bundle. None where open_bundle_chunks_i16 gives None."""
    chunked = open_bundle_chunks_i16(bundle_root, pad_multiple, num_threads)
    if chunked is None:
        return None
    meta, lengths, names, _n_max, loader = chunked
    batch = loader(0, len(names))
    if loader.interleaved:
        batch = np.ascontiguousarray(batch.transpose(0, 2, 1))
    return meta, batch, lengths, names


def open_bundle_chunks_i16(bundle_root: str | Path, pad_multiple: int = 4096, num_threads: int = 8):
    """Chunked PCM16 fast path for pipelined decode: (meta, (B,) int32
    lengths, names, n_max, loader), a ChunkLoader of planar
    (hi-lo, 2, n_max) int16 chunks from the native decoder, or, when the
    taps have C > 2 channels, of interleaved (hi-lo, n_max, C) ones
    (read_interleaved_i16). Every tap's header is probed and vetted as
    plain PCM16 up front, so the padded shape is fixed and loader() cannot
    fail on format mid-pipeline. None when any tap is not plain PCM16, or
    for a mono or stereo bundle when the native library is missing."""
    bundle_root = Path(bundle_root)
    meta = read_bundle_meta(bundle_root)
    paths = _tap_paths(bundle_root, meta)
    lengths, n_max, channels = _probe_taps(paths, meta, pad_multiple)
    if (channels <= 2 and not native.available()) or not all(wav_is_plain_pcm16(p) for p in paths):
        return None

    def read_interleaved(lo: int, hi: int, out: np.ndarray | None):
        return read_interleaved_i16(paths[lo:hi], n_max, channels, out)

    def read_planar(lo: int, hi: int):
        result = native.read_bundle_planar_i16(paths[lo:hi], n_max, 2, num_threads)
        if result is None:
            raise IOError(f"Bundle taps [{lo}:{hi}) are not plain PCM16; use load_bundle_batch instead")
        return result[0]

    loader = ChunkLoader(read_interleaved, channels, True) if channels > 2 else ChunkLoader(read_planar, 2, False)
    return meta, np.asarray(lengths, np.int32), meta.taps, n_max, loader


def open_bundle_chunks(bundle_root: str | Path, pad_multiple: int = 4096, num_threads: int = 8):
    """Chunked decode of any bundle, as open_bundle_chunks_i16: the PCM16
    fast path where it applies, else a ChunkLoader of planar
    (hi-lo, C, n_max) float32 chunks, mono taps upmixed where C = 2.
    Every tap's header is probed and its rate and channels checked up
    front, with or without the native library."""
    chunked = open_bundle_chunks_i16(bundle_root, pad_multiple, num_threads)
    if chunked is not None:
        return chunked
    bundle_root = Path(bundle_root)
    meta = read_bundle_meta(bundle_root)
    paths = _tap_paths(bundle_root, meta)
    lengths, n_max, channels = _probe_taps(paths, meta, pad_multiple)

    def read(lo: int, hi: int):
        return _decode_f32(paths[lo:hi], meta.sample_rate_hz, channels, n_max, num_threads)

    return meta, np.asarray(lengths, np.int32), meta.taps, n_max, ChunkLoader(read, channels, False)
