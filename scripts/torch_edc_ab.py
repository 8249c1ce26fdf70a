#!/usr/bin/env python3
"""
Time builds of the port's EDC kernel source (audio_analysis_tpu_torch/csrc/
edc.cu, C entry aa_edc_db) side by side on one NVIDIA GPU, at the main
path's shapes (16 and 48 rows x 2^20, plus 64 rows), against the plain torch
version. Run from the repository root:

    python3 scripts/torch_edc_ab.py [--source LABEL=PATH ...] [--lead L ...]

Variants: the tree's csrc/edc.cu ("tree"), each --source (for example the
parent commit's edc.cu from a `git archive`), and the tree's source with
its kLead constant replaced by each --lead. A plain streaming kernel that
reads x once and writes x^2 once ("copy") is timed beside them as the
practical ceiling for the same bytes; it is a yardstick only. Each variant
is compiled by its own nvcc process, all at once, into its own library
under build/edc_ab/.

Per variant and shape: the median and least of 25 CUDA-event times of one
C-entry call (the device time of the memset and the launch, without the
Python wrapper), the share of the bound (one read and one write of the
plane at 3.35 TB/s), the max dB error above -100 dB against the plain
version, whether index 0 is exactly 0 dB, and whether two calls are
bit-identical. The variants run in order and then in reverse, on the same
inputs. Prints the card's name and power limit first and one JSON line
last. Needs CUDA and nvcc; no result without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "edc_ab"
N = 1 << 20
HBM_BYTES_PER_S = 3.35e12
COPY_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void copy_kernel(const float4* __restrict__ x, float4* __restrict__ out, long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    float4 v = __ldcs(x + i);
    v.x *= v.x, v.y *= v.y, v.z *= v.z, v.w *= v.w;
    __stcs(out + i, v);
  }
}
extern "C" int aa_edc_db(const float* x, const int*, float*, float* out, long long rows,
                         long long n, float, float, void* stream) {
  copy_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>((const float4*)x, (float4*)out, rows * n / 4);
  return (int)cudaGetLastError();
}
"""


def build(label: str, source: str) -> tuple:
    from torch.utils.cpp_extension import CUDA_HOME

    src, lib = OUT / f"{label}.cu", OUT / f"lib{label}.so"
    src.write_text(source)
    proc = subprocess.run(
        [str(Path(CUDA_HOME) / "bin" / "nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-o", str(lib), str(src)],
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {label}:\n{proc.stderr}")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", proc.stderr)]
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", proc.stderr))
    return label, lib, regs, spills


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], help="LABEL=PATH of another edc.cu")
    ap.add_argument("--lead", action="append", type=int, default=[], help="kLead of a variant of the tree's source")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("torch_edc_ab.py: needs an NVIDIA GPU with CUDA", file=sys.stderr)
        return 2
    from audio_analysis_tpu_torch.ops import edc

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    tree = (REPO / "audio_analysis_tpu_torch" / "csrc" / "edc.cu").read_text()
    sources = {"tree": tree}
    for item in args.source:
        label, path = item.split("=", 1)
        sources[label] = Path(path).read_text()
    for lead in args.lead:
        if tree.count("constexpr int kLead = ") != 1:
            raise RuntimeError("the tree's edc.cu has no single kLead constant")
        sources[f"lead{lead}"] = re.sub(r"constexpr int kLead = \d+;", f"constexpr int kLead = {lead};", tree)
    sources["copy"] = COPY_SOURCE
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(lambda kv: build(*kv), sources.items()))
    libs = {}
    for label, path, regs, spills in built:
        lib = ctypes.CDLL(str(path))
        p, i64, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
        lib.aa_edc_db.argtypes = [p, p, p, p, i64, i64, f32, f32, p]
        lib.aa_edc_db.restype = ctypes.c_int
        libs[label] = lib
        print(f"{label}: registers {regs}, spill store bytes {spills}", flush=True)

    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    results = []
    for rows in (16, 48, 64):
        t = torch.arange(N, dtype=torch.float32)
        x = (0.01 * torch.randn(rows, N, generator=g) * torch.exp(-t / 30000.0)).to(dev)
        lengths = torch.full((rows,), N, dtype=torch.int32, device=dev)
        lengths[1] = N - 5000
        ref = edc.schroeder_edc_db_plain(x, lengths)
        usable = ref > -100.0
        # room for every layout the variants use (tile totals, flags, counters)
        scratch = torch.empty(2 * rows * (N // 4096 + 1) + rows + 2, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        bound_ms = rows * N * 8 / HBM_BYTES_PER_S * 1e3
        order = list(libs.items())
        for label, lib in order + order[::-1]:
            def call(out, lib=lib):
                code = lib.aa_edc_db(x.data_ptr(), lengths.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                                     rows, N, 1e-20, -120.0, stream)
                if code != 0:
                    raise RuntimeError(f"{label}: CUDA error {code}")

            a, b = torch.empty_like(x), torch.empty_like(x)
            call(a)
            call(b)
            torch.cuda.synchronize()
            times = []
            for _ in range(25):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                call(a)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            row = {
                "variant": label, "rows": rows, "ms": statistics.median(times), "min_ms": min(times),
                "bound_ms": bound_ms, "bound_share": bound_ms / statistics.median(times),
            }
            if label != "copy":
                row.update(
                    max_err_db=(a - ref).abs()[usable].max().item(),
                    zero_db_at_0=bool((a[:, 0] == 0).all()),
                    bit_identical=torch.equal(a.view(torch.int32), b.view(torch.int32)),
                )
            results.append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps({"edc_ab": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
