"""The STFT kernel's CUDA source (audio_analysis_tpu_torch/csrc/stft.cu) run
on the CPU against its plain torch version.

g++ compiles the .cu file as C++ against tests/cuda_host/cuda_runtime.h, a
stand-in for the CUDA subset the kernel uses: each CUDA thread of a block
is a std::thread and __syncthreads a barrier, so the kernel's index
arithmetic, its pass plan for every n_fft, its shared-memory exchanges and
both load paths (8-byte and scalar) run here exactly as written. Two
spots of the source are rewritten textually: the `extern __shared__`
buffer and the `<<<...>>>` launch. What this cannot show (it compiles with
g++, not nvcc; no warps, registers or timing) is left to
tests/test_torch_cuda.py and chip_smoke.py on the card.

Tolerance as on the card: max |err| / max(ref) < 1e-5 (fp32 FFT against
torch.fft; the error measured here is about 3e-7), and exactly the same
zeros (frames not wholly inside `length`).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_analysis_tpu_torch.ops import stft

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "audio_analysis_tpu_torch" / "csrc" / "stft.cu"
HOST_INCLUDE = Path(__file__).resolve().parent / "cuda_host"

_SHARED = "extern __shared__ float2 smem[];"
_LAUNCH = "stft_mag_kernel<LOG2M><<<(unsigned)blocks, P::THREADS, smem, stream>>>("


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    src = SOURCE.read_text()
    assert src.count(_SHARED) == 1 and src.count(_LAUNCH) == 1, "kernel source changed shape"
    src = src.replace(_SHARED, "float2* smem = reinterpret_cast<float2*>(host_shared_memory.data());")
    src = src.replace(_LAUNCH, "host_launch(stft_mag_kernel<LOG2M>, (unsigned)blocks, P::THREADS, smem, ")
    out = tmp_path_factory.mktemp("stft_host")
    (out / "stft_host.cpp").write_text(src)
    so = out / "libstft_host.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", f"-I{HOST_INCLUDE}", "-o", str(so),
         str(out / "stft_host.cpp"), "-lpthread"],
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.aa_stft_mag.argtypes = [p, p, p, p, p, i64, i64, i32, i32, i32, i32, ctypes.c_float, p]
    lib.aa_stft_mag.restype = i32
    return lib


def _host_stft(lib, x, lengths, n_fft, hop, k_out, floor_lin=1e-6):
    """The kernel through its C entry, on host memory, launched as
    ops/stft.py launches it (arguments and tables alike)."""
    rows, n = x.shape
    frames = stft.num_frames_static(n, n_fft, hop)
    k = n_fft // 2 + 1 if k_out is None else k_out
    window = stft._window(n_fft, True, torch.device("cpu"))
    twiddle = stft._twiddle(n_fft, torch.device("cpu"))
    out = torch.full((rows, frames, k), float("nan"))
    code = lib.aa_stft_mag(
        x.data_ptr(), lengths.data_ptr(), window.data_ptr(), twiddle.data_ptr(), out.data_ptr(),
        rows, n, n_fft, hop, frames, k, floor_lin, None,
    )
    return code, out


# (n_fft, hop, k_out, rows, n, storage offset in floats, lengths): every
# n_fft the kernel takes, odd hops and an odd row length (frame starts off
# 8-byte alignment: the scalar load path), a base one float into its
# storage, k_out of 1, of n_fft/2 + 1 and the modal 3415, lengths that cut
# frames, and blocks of several frames with empty slots at the end
CASES = [
    (256, 64, None, 2, 773, 0, (773, 512)),
    (256, 63, 100, 3, 1000, 1, (1000, 600, 255)),
    (512, 128, None, 2, 1541, 0, (1541, 1024)),
    (1024, 256, 1, 2, 3077, 0, (3077, 2048)),
    (1024, 129, None, 2, 3000, 3, (3000, 3000)),
    (2048, 512, None, 2, 6149, 0, (6149, 4096)),
    (2048, 1, 7, 1, 2068, 0, (2068,)),
    (4096, 512, None, 2, 6144, 0, (6144, 5000)),
    (4096, 509, 2049, 1, 6000, 1, (6000,)),
    (8192, 512, 3415, 1, 9735, 0, (8792,)),
    (8192, 2048, None, 1, 16384, 2, (16384,)),
    (16384, 4096, None, 2, 24581, 0, (24581, 16384)),
]


@pytest.mark.parametrize("n_fft,hop,k_out,rows,n,offset,lengths", CASES)
def test_kernel_source_matches_plain(lib, n_fft, hop, k_out, rows, n, offset, lengths):
    rng = np.random.default_rng(n_fft + hop + offset)
    base = torch.from_numpy(rng.standard_normal(rows * n + offset).astype(np.float32))
    x = base[offset:].view(rows, n)
    length = torch.tensor(lengths, dtype=torch.int32)
    code, got = _host_stft(lib, x, length, n_fft, hop, k_out)
    assert code == 0
    ref = stft.stft_magnitude_plain(x, length, n_fft, hop, True, 1e-6, k_out)
    assert got.shape == ref.shape
    assert ((got - ref).abs().max() / ref.abs().max()).item() < 1e-5
    assert torch.equal(got == 0, ref == 0)


@pytest.mark.parametrize(
    "n_fft,hop,k_out,frames",
    [(128, 64, 65, 1), (32768, 512, 100, 1), (3000, 512, 100, 1), (4096, 0, 100, 1),
     (4096, 512, 2050, 1), (4096, 512, 0, 1), (4096, 512, 100, 100)],
)
def test_kernel_entry_refuses_bad_arguments(lib, n_fft, hop, k_out, frames):
    x = torch.zeros(1, 40_000)
    out = torch.zeros(1)
    code = lib.aa_stft_mag(
        x.data_ptr(), torch.zeros(1, dtype=torch.int32).data_ptr(), x.data_ptr(), x.data_ptr(),
        out.data_ptr(), 1, 40_000, n_fft, hop, frames, k_out, 0.0, None,
    )
    assert code != 0
