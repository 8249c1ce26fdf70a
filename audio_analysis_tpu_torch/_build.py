"""
Build and load the hand-written CUDA kernels in `csrc/`.

The sources export a plain C interface (no PyTorch headers). nvcc compiles
each source to an object, all of them at once in parallel processes, and
links the objects into one shared library that is loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -Xptxas -v -c csrc/<name>.cu -o <name>.o        # one per source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o \
         build/aa_torch_kernels/libaa_torch_kernels-<hash>.so *.o

The build runs at first use. The file name carries a hash of the sources
and flags, so an edited source is rebuilt and a stale library is never
loaded. The compiler's report (`-Xptxas -v`: registers, shared memory,
spills per kernel) is kept beside the library as `<name>.log`.

Every C entry launches on the stream it is given (PyTorch's current
stream), allocates nothing, and returns `cudaGetLastError()`; `check`
turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import weakref
from pathlib import Path
from typing import Optional

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "aa_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_F32 = ctypes.c_float

# name -> argtypes of every exported C entry (all return a cudaError_t as int)
_SIGNATURES = {
    # x, lengths, tile_sums, out, rows, n, eps, floor_db, stream
    "aa_edc_db": [_P, _P, _P, _P, _I64, _I64, _F32, _F32, _P],
    # x, lengths, window, twiddle, out, rows, n, n_fft, hop, frames, k_out, floor_lin, stream
    "aa_stft_mag": [_P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32, _I32, _F32, _P],
    # init, out, strings, delay, total, g, b, stream
    "aa_karplus": [_P, _P, _I64, _I64, _I64, _F32, _F32, _P],
    # x, num_frames, spans, scratch, out, channels, frames, bins, i0, n_sel, rows, col_pool, stream
    "aa_pool_image": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I32, _I32, _I32, _I32, _P],
    # block, stream
    "aa_mark": [_I32, _P],
    # curve, lengths, scratch, out_f, out_num, out_ok, rows, n, dt, range_db (host), ranges, min_points, stream
    "aa_dbfit": [_P, _P, _P, _P, _P, _P, _I64, _I64, _F32, _P, _I32, _I32, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class LaunchCounter:
    """Counts the launches of one kernel: its wrapper adds one where it
    launches the kernel, and nowhere else (a CUDA graph's replay, which
    runs no wrapper, adds what its capture launched: engine/graphs.py)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.launches = 0
        _counters.add(self)


_counters: "weakref.WeakSet[LaunchCounter]" = weakref.WeakSet()


def launch_counters() -> list:
    """Every live LaunchCounter."""
    return list(_counters)


def _sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for flag in NVCC_FLAGS:
        digest.update(flag.encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libaa_torch_kernels-{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _run_all(cmds: list) -> tuple:
    """Run the commands in parallel; (first non-zero exit code or 0, log)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    log, code = "", 0
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        log += " ".join(cmd) + "\n" + out
        code = code or proc.returncode
    return code, log


def build() -> Path:
    """Compile csrc/*.cu into the hashed library if it is not built yet."""
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = lib_path.with_suffix(f".tmp{os.getpid()}")
    objs = [f"{stem}.{src.stem}.o" for src in _sources()]
    code, log = _run_all(
        [[_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", obj] for src, obj in zip(_sources(), objs)]
    )
    if code == 0:
        link_code, link_log = _run_all([[_nvcc(), *ARCH_FLAGS, "-shared", "-o", f"{stem}.so", *objs]])
        code, log = link_code, log + link_log
    lib_path.with_suffix(".log").write_text(log)
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    if code != 0:
        raise RuntimeError(f"nvcc failed ({code}):\n{log}")
    os.replace(f"{stem}.so", lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.aa_error_string.argtypes = [ctypes.c_int]
            lib.aa_error_string.restype = ctypes.c_char_p
            lib.aa_edc_tile_size.argtypes = []
            lib.aa_edc_tile_size.restype = ctypes.c_int
            lib.aa_pool_scratch_bytes.argtypes = [_I64]
            lib.aa_pool_scratch_bytes.restype = _I64
            lib.aa_dbfit_scratch_bytes.argtypes = [_I64, _I64]
            lib.aa_dbfit_scratch_bytes.restype = _I64
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (refused launch, bad args)."""
    if code != 0:
        msg = library().aa_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
