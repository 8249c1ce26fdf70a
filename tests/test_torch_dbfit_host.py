"""The decay-fit kernel's CUDA source (audio_analysis_tpu_torch/csrc/dbfit.cu,
K5) run on the CPU against its plain torch version.

g++ compiles the .cu file as C++ against tests/cuda_host/cuda_runtime.h
(tests/_cuda_host_build.py): each CUDA thread of a block a std::thread,
__syncthreads a barrier, a warp shuffle an exchange between per-warp
barriers, blocks one after another, on a stand-in card of 4 resident
blocks, so that a row spans several blocks of each pass. The C entry is
called through `dbfit.run_kernel`, the wrapper's own code, on host memory.
So pass 1's spans and its early stop, pass 2's crossings, windows, pieces,
float64 sums and the row's last block run here exactly as written. What
this cannot show (g++, not nvcc: no fused multiply-add to refuse; no
concurrency between blocks; no timing) is left to tests/test_torch_cuda.py
and chip_smoke.py on the card.

Checks (tests/_dbfit_compare.py): crossing times, point counts and `ok`
(on these curves, whose slopes' signs are clear) bit-equal to
`fit_decay_ranges_plain`; slope, intercept, r^2 and RT60
within its TOLERANCE of the plain version and within one float32 rounding
of a float64 fit over the same window; two calls, and a call with the
blocks in reverse order, bit-identical.
"""

import ctypes

import numpy as np
import pytest
import torch

from _cuda_host_build import build_host_library
from _dbfit_compare import assert_edge_rows_cornered, assert_fits_agree, edge_curves
from audio_analysis_tpu_torch.ops import dbfit, edc

SR = 48_000
ENGINE_RANGES = ((-5.0, -35.0), (-5.0, -25.0), (0.0, -10.0))  # the bands block's T30, T20, EDT
_HOST_ENTRIES = """
extern "C" void host_set_reverse_blocks(int on) { host_reverse_blocks = on != 0; }
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = build_host_library("dbfit", 2, tmp_path_factory.mktemp("dbfit_host"), _HOST_ENTRIES)
    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.aa_dbfit.argtypes = [p, p, p, p, p, p, i64, i64, f32, p, i32, i32, p]
    lib.aa_dbfit.restype = i32
    lib.aa_dbfit_scratch_bytes.argtypes = [i64, i64]
    lib.aa_dbfit_scratch_bytes.restype = i64
    lib.host_set_reverse_blocks.argtypes = [i32]
    return lib


def _host_fits(lib, curve, lengths, ranges, sr, min_points=8, fit_lower=-80.0):
    code, fits = dbfit.run_kernel(lib, curve, lengths, ranges, fit_lower, sr, min_points, None)
    assert code == 0
    return fits


def _edc_plane(rows: int, n: int, seed: int):
    """K1's plain curves of decaying noise, T60 0.05-0.6 s, with drawn
    lengths (the first row whole)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = (rng.standard_normal((rows, n)) * 10.0 ** (-3.0 * t / rng.uniform(0.05, 0.6, (rows, 1)))).astype(np.float32)
    lengths = rng.integers(n // 3, n + 1, rows).astype(np.int32)
    lengths[0] = n
    x[np.arange(n)[None, :] >= lengths[:, None]] = 0.0
    lengths_t = torch.from_numpy(lengths)
    return edc.schroeder_edc_db_plain(torch.from_numpy(x), lengths_t), lengths_t


# rows, n, sample rate, ranges, fit lower limit, min points: 16-byte rows
# (the vector path) and rows that are not (40,001 samples: the scalar
# path), one row over 4 blocks, a decimated rate, four ranges sharing
# levels with a lower limit above one range's end, and a min_points that
# refuses some fits
CASES = {
    "engine_ranges": (4, 40_960, SR, ENGINE_RANGES, -80.0, 8),
    "unaligned_rows": (3, 40_001, SR, ENGINE_RANGES, -80.0, 8),
    "one_row": (1, 20_480, SR, ENGINE_RANGES, -80.0, 8),
    "decimated": (4, 16_384, SR / 4, ENGINE_RANGES, -80.0, 8),
    "four_ranges_lower_limit": (3, 30_000, SR, ((0.0, -10.0), (-5.0, -25.0), (-5.0, -35.0), (-15.0, -45.0)), -40.0, 8),
    "min_points_refuses": (4, 24_576, SR, ENGINE_RANGES, -80.0, 6_000),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_source_matches_plain(lib, case):
    rows, n, sr, ranges, fit_lower, min_points = CASES[case]
    curve, lengths = _edc_plane(rows, n, rows + n)
    got = _host_fits(lib, curve, lengths, ranges, sr, min_points, fit_lower)
    ref = dbfit.fit_decay_ranges_plain(curve, lengths, ranges, fit_lower, sr, min_points)
    assert_fits_agree(got, ref, curve.numpy(), lengths.numpy(), dbfit._seconds_per_sample(sr))
    if case == "min_points_refuses":
        assert not all(bool(f.ok.all()) for f in ref) and any(bool(f.ok.any()) for f in ref)


def test_kernel_source_edge_rows(lib):
    curve, lengths = edge_curves(4096 + 3)
    got = _host_fits(lib, curve, lengths, ENGINE_RANGES, SR)
    ref = dbfit.fit_decay_ranges_plain(curve, lengths, ENGINE_RANGES, -80.0, SR)
    assert_edge_rows_cornered(ref)
    assert_fits_agree(got, ref, curve.numpy(), lengths.numpy(), dbfit._seconds_per_sample(SR))


def test_kernel_source_two_calls_and_reversed_blocks_bit_identical(lib):
    curve, lengths = _edc_plane(3, 28_672, 7)
    first = _host_fits(lib, curve, lengths, ENGINE_RANGES, SR)
    second = _host_fits(lib, curve, lengths, ENGINE_RANGES, SR)
    lib.host_set_reverse_blocks(1)
    try:
        reversed_ = _host_fits(lib, curve, lengths, ENGINE_RANGES, SR)
    finally:
        lib.host_set_reverse_blocks(0)
    for a, b, c in zip(first, second, reversed_):
        for name in a._fields:
            assert torch.equal(getattr(a, name), getattr(b, name)), name
            assert torch.equal(getattr(a, name), getattr(c, name)), name


@pytest.mark.parametrize("count", [dbfit.MAX_RANGES, dbfit.MAX_RANGES + 1])
def test_kernel_source_takes_max_ranges_and_refuses_more(lib, count):
    """The C entry's range limit (kMaxRanges) is the wrapper's MAX_RANGES."""
    curve, lengths = _edc_plane(2, 8192, 5)
    ranges = ((0.0, -10.0), (-5.0, -15.0), (-5.0, -25.0), (-5.0, -35.0), (-10.0, -40.0))[:count]
    code, fits = dbfit.run_kernel(lib, curve, lengths, ranges, -80.0, SR, 8, None)
    if count > dbfit.MAX_RANGES:
        assert code == 1  # cudaErrorInvalidValue
        return
    assert code == 0
    ref = dbfit.fit_decay_ranges_plain(curve, lengths, ranges, -80.0, SR)
    assert_fits_agree(fits, ref, curve.numpy(), lengths.numpy(), dbfit._seconds_per_sample(SR))
