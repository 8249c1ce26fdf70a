"""Build a kernel source of audio_analysis_tpu_torch/csrc/ for the CPU.

g++ compiles the .cu file as C++ against tests/cuda_host/cuda_runtime.h, the
stand-in for the CUDA subset the kernels use (each CUDA thread of a block a
std::thread, __syncthreads a barrier, a warp shuffle an exchange between
per-warp barriers, blocks one after another). Two spots are rewritten
textually: each `kernel<<<grid, threads, smem, stream>>>(` launch, which
becomes `host_launch(kernel, grid, threads, smem, `, and each
`extern __shared__ T name[];` declaration, which becomes a pointer into the
launch's shared buffer. The C entries are then called through ctypes on
host memory, exactly as the wrappers call them on the card.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "audio_analysis_tpu_torch" / "csrc"
HOST_INCLUDE = Path(__file__).resolve().parent / "cuda_host"

_LAUNCH = re.compile(r"(\w+)<<<([^,<>]+), ([^,<>]+), ([^,<>]+), (\w+)>>>\(")
_EXTERN_SHARED = re.compile(r"extern __shared__ (\w+) (\w+)\[\];")


def build_host_library(name: str, launches: int, out_dir: Path, extra: str = "") -> ctypes.CDLL:
    """csrc/<name>.cu with its `launches` launches rewritten and the
    host-only source `extra` appended, compiled into a shared library in
    `out_dir` and loaded."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    src, found = _LAUNCH.subn(r"host_launch(\1, \2, \3, \4, ", (CSRC / f"{name}.cu").read_text())
    assert found == launches, f"kernel source changed shape: {found} launches, expected {launches}"
    src = _EXTERN_SHARED.sub(r"\1* \2 = reinterpret_cast<\1*>(host_shared_memory.data());", src)
    cpp, so = out_dir / f"{name}_host.cpp", out_dir / f"lib{name}_host.so"
    cpp.write_text(src + extra)
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", f"-I{HOST_INCLUDE}", "-o", str(so), str(cpp), "-lpthread"],
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(so))
