"""
ctypes binding to the native C++ audio I/O library built from the repo's
cpp/audioio.cpp by cpp/Makefile (`make -C cpp` -> cpp/build/libaudioio.so).

The library provides single-file WAV probe/decode, PCM16 WAV encode, and
multithreaded bundle decode of all taps into one padded buffer (float32
interleaved, or planar int16 for the PCM16 fast path). `available()` is
False until the library is built; callers then use the scipy path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

CPP_DIR = Path(__file__).resolve().parents[2] / "cpp"

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
_override_error: Optional[OSError] = None
# set after a failed `make -C cpp`, so repeat callers do not rebuild
_build_failed = False


def _lib_candidates() -> List[Path]:
    return [CPP_DIR / "build" / "libaudioio.so", CPP_DIR / "libaudioio.so"]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted, _override_error
    if _load_attempted:
        if _override_error is not None:
            raise _override_error
        return _lib
    _load_attempted = True
    override = os.environ.get("AA_AUDIOIO_LIB")
    if override:
        # an explicit library path is honoured or fails loudly; it never
        # falls back to the repo's build
        try:
            lib = ctypes.CDLL(override)
        except OSError as exc:
            _override_error = exc
            raise
        _configure(lib)
        _lib = lib
        return _lib
    for candidate in _lib_candidates():
        if candidate.exists():
            try:
                lib = ctypes.CDLL(str(candidate))
            except OSError:
                continue
            _configure(lib)
            _lib = lib
            break
    return _lib


def _configure(lib: ctypes.CDLL) -> None:
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    lib.aa_read_wav_info.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(i64), ctypes.POINTER(i32), ctypes.POINTER(i32),
    ]  # path, frames, channels, sample rate
    lib.aa_read_wav_info.restype = i32
    lib.aa_read_wav_f32.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), i64]
    lib.aa_read_wav_f32.restype = i32  # path, interleaved out, capacity in floats
    lib.aa_write_wav_pcm16.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int16), i64, i32, i32]
    lib.aa_write_wav_pcm16.restype = i32  # path, samples, frames, channels, rate
    # paths, num files, out, N_max (frames), C, out lengths, num threads
    lib.aa_read_bundle_f32.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), i32, ctypes.POINTER(ctypes.c_float), i64, i32,
        ctypes.POINTER(i64), i32,
    ]
    lib.aa_read_bundle_f32.restype = i32
    lib.aa_read_bundle_planar_i16.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), i32, ctypes.POINTER(ctypes.c_int16), i64, i32,
        ctypes.POINTER(i64), i32,
    ]
    lib.aa_read_bundle_planar_i16.restype = i32


def available() -> bool:
    return _load() is not None


def ensure_built(timeout_s: float = 180.0) -> bool:
    """Build the library with `make -C cpp` if it is not loadable yet, then
    load it. Returns available(); never raises. A failed build is
    remembered for the life of the process."""
    global _lib, _load_attempted, _build_failed
    if available() or os.environ.get("AA_AUDIOIO_LIB"):
        return available()
    if _build_failed:
        return False
    if not (CPP_DIR / "Makefile").exists():
        _build_failed = True
        return False
    try:
        subprocess.run(["make", "-C", str(CPP_DIR)], capture_output=True, timeout=timeout_s, check=True)
    except Exception:
        _build_failed = True
        return False
    _lib, _load_attempted = None, False
    return available()


def read_wav_info(path: str | Path) -> Tuple[int, int, int]:
    """(frames, channels, sample_rate_hz) without decoding samples."""
    lib = _load()
    assert lib is not None
    frames, channels, rate = ctypes.c_int64(0), ctypes.c_int32(0), ctypes.c_int32(0)
    rc = lib.aa_read_wav_info(
        str(path).encode(), ctypes.byref(frames), ctypes.byref(channels), ctypes.byref(rate)
    )
    if rc != 0:
        raise IOError(f"native WAV probe failed ({rc}): {path}")
    return frames.value, channels.value, rate.value


def read_wav(path: str | Path) -> Tuple[int, np.ndarray]:
    """Decode a WAV file to float32: (sample_rate_hz, (N,) or (N, C))."""
    lib = _load()
    assert lib is not None
    frames, channels, rate = read_wav_info(path)
    out = np.empty(frames * channels, dtype=np.float32)
    rc = lib.aa_read_wav_f32(
        str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.c_int64(out.size)
    )
    if rc != 0:
        raise IOError(f"native WAV decode failed ({rc}): {path}")
    if channels > 1:
        out = out.reshape(frames, channels)
    return rate, out


def write_wav_pcm16(path: str | Path, int16_samples: np.ndarray, sample_rate_hz: int) -> None:
    lib = _load()
    assert lib is not None
    x = np.ascontiguousarray(int16_samples, dtype=np.int16)
    frames, channels = (x.size, 1) if x.ndim == 1 else x.shape
    rc = lib.aa_write_wav_pcm16(
        str(path).encode(), x.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ctypes.c_int64(frames), ctypes.c_int32(channels), ctypes.c_int32(sample_rate_hz),
    )
    if rc != 0:
        raise IOError(f"native WAV encode failed ({rc}): {path}")


def _paths(paths: List[Path]):
    return (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])


def read_bundle(
    paths: List[Path], n_max: int, channels: int, num_threads: int = 8
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode many WAVs in parallel into one zero-padded (B, N_max, C)
    float32 buffer; mono files are duplicated to C channels. Returns
    (batch, lengths)."""
    lib = _load()
    assert lib is not None
    out = np.zeros((len(paths), n_max, channels), dtype=np.float32)
    lengths = np.zeros(len(paths), dtype=np.int64)
    rc = lib.aa_read_bundle_f32(
        _paths(paths), ctypes.c_int32(len(paths)), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(n_max), ctypes.c_int32(channels),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), ctypes.c_int32(num_threads),
    )
    if rc != 0:
        raise IOError(f"native bundle decode failed ({rc})")
    return out, lengths


def read_bundle_planar_i16(
    paths: List[Path], n_max: int, channels: int, num_threads: int = 8
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """PCM16 fast path: a zero-padded planar (B, C, N_max) int16 batch and
    its lengths, half the bytes of the float32 path on the host and across
    the host->device copy. None when any tap is not plain PCM16."""
    lib = _load()
    assert lib is not None
    out = np.zeros((len(paths), channels, n_max), dtype=np.int16)
    lengths = np.zeros(len(paths), dtype=np.int64)
    rc = lib.aa_read_bundle_planar_i16(
        _paths(paths), ctypes.c_int32(len(paths)), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ctypes.c_int64(n_max), ctypes.c_int32(channels),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), ctypes.c_int32(num_threads),
    )
    if rc == -3:  # not PCM16: the caller uses the float32 path
        return None
    if rc != 0:
        raise IOError(f"native planar-i16 bundle decode failed ({rc})")
    return out, lengths
