"""The display pooling kernel's CUDA source (audio_analysis_tpu_torch/csrc/
pool.cu, K4) run on the CPU against its plain torch version.

The source is compiled with g++ against tests/cuda_host/cuda_runtime.h
(tests/_cuda_host_build.py) and called through its C entry with the
arguments ops/display.py's wrapper gives it: the plane, the valid frame
counts, the rows' bin ranges of `_log_row_spans`, and the colour
percentiles of `_colour_percentiles`. Its output is held to
`_pooled_image_plain` (the shifted-maximum pyramid), whose parity with the
JAX package is tests/test_torch_display.py's. What this cannot show (g++,
not nvcc; no timing) is left to tests/test_torch_cuda.py and chip_smoke.py
on the card.

Tolerance: none. Max is exact and both quantise alike, so the int16 image
and its percentile column must be equal.
"""

import ctypes

import numpy as np
import pytest
import torch

from _cuda_host_build import build_host_library
from audio_analysis_tpu_torch.ops import display

SR = 48_000


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = build_host_library("pool", 1, tmp_path_factory.mktemp("pool_host"))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.aa_pool_image.argtypes = [p, p, p, p, p, i64, i64, i64, i32, i32, i32, p]
    lib.aa_pool_image.restype = i32
    return lib


def _plane(seed: int, c: int, t: int, n_fft: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    plane = rng.uniform(-120.0, 0.0, (c, t, n_fft // 2 + 1)).astype(np.float32)
    # loud cells (the maxima), and cells past the +-255.99 dB clip
    plane[:, rng.integers(0, t, 6), rng.integers(0, n_fft // 2, 6)] = 3.0
    plane[:, rng.integers(0, t, 3), rng.integers(0, n_fft // 2, 3)] = 300.0
    plane[:, rng.integers(0, t, 3), rng.integers(0, n_fft // 2, 3)] = -400.0
    return torch.from_numpy(plane)


def _key(n_fft: int, rows: int, f_min: float = 20.0, f_max: float = 20_000.0) -> tuple:
    i0, i1 = display.freq_selection(n_fft, SR, f_min, f_max)
    return (n_fft, SR, i0, i1, f_min, f_max, rows)


def _host_pool(lib, plane: torch.Tensor, num_frames: torch.Tensor, key: tuple, col_pool: int) -> torch.Tensor:
    """The kernel through its C entry on host memory, with the arguments
    of ops/display.py _pooled_image_cuda, into an output of -1s."""
    c, t, f = plane.shape
    i0, i1, rows = key[2], key[3], key[6]
    spans = torch.from_numpy(display._log_row_spans(*key))
    pcts = display._colour_percentiles(plane, display._valid_frames(plane, num_frames), i0, i1).contiguous()
    out = torch.full((c, -(-t // col_pool) + 1, rows), -1, dtype=torch.int16)
    code = lib.aa_pool_image(plane.data_ptr(), num_frames.data_ptr(), spans.data_ptr(), pcts.data_ptr(),
                             out.data_ptr(), c, t, f, i0, rows, col_pool, None)
    assert code == 0
    return out


# (id, n_fft, frames, valid frames per channel, rows, col_pool): column
# pooling 1, 2 and 3 with frames no multiple of it; valid counts below the
# frame count and 0 (percentiles NaN, cells the empty value); one channel;
# rows narrower than a bin (n_fft 256: 187.5 Hz bins, 40 or 720 rows
# from 20 Hz) and the report's 720 rows
CASES = [
    ("col_pool_1", 256, 17, (17, 17), 40, 1),
    ("col_pool_2", 256, 17, (17, 17), 40, 2),
    ("col_pool_3", 256, 17, (17, 17), 40, 3),
    ("valid_below_frames", 256, 17, (17, 11), 40, 2),
    ("valid_in_the_first_bucket", 256, 17, (2, 1), 40, 3),
    ("valid_zero", 256, 17, (17, 0), 40, 2),
    ("valid_past_frames", 256, 9, (30, 9), 40, 1),
    ("one_channel", 256, 10, (10,), 40, 3),
    ("report_rows_sub_bin", 1024, 9, (9, 8), 720, 2),
    ("wide_rows", 4096, 5, (5, 4), 24, 1),
]


@pytest.mark.parametrize("n_fft,t,valid,rows,col_pool", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_kernel_source_equal_to_plain(lib, n_fft, t, valid, rows, col_pool):
    plane = _plane(n_fft + t + rows, len(valid), t, n_fft)
    nf = torch.tensor(valid, dtype=torch.int64)
    key = _key(n_fft, rows)
    got = _host_pool(lib, plane, nf, key, col_pool)
    ref = display._pooled_image_plain(plane, nf, key, col_pool)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert torch.equal(got, ref)
    spans = display._log_row_spans(*key)
    if rows > 40:
        assert (spans[:, 1] == 1).sum() > rows // 4  # many rows narrower than a bin
    for c, v in enumerate(valid):
        if v == 0:
            assert bool((got[c, :-1] == -32767).all())  # every cell the empty value
            assert bool((got[c, -1] == 0).all())  # NaN percentiles quantise to 0


def test_a_narrow_selection_off_the_first_bin(lib):
    """A selection that starts well inside the plane (i0 > 0) and rows
    wider than one bin."""
    plane = _plane(5, 2, 12, 512)
    nf = torch.tensor([12, 7], dtype=torch.int64)
    key = _key(512, 16, 2_000.0, 9_000.0)
    assert key[2] > 10
    assert torch.equal(_host_pool(lib, plane, nf, key, 2), display._pooled_image_plain(plane, nf, key, 2))


@pytest.mark.parametrize(
    "channels,frames,rows,col_pool,null",
    [(-1, 4, 8, 1, None), (1, -1, 8, 1, None), (1, 4, -1, 1, None), (1, 4, 8, 0, None), (1, 4, 8, 1, "x"),
     (1, 4, 8, 1, "num_frames"), (1, 4, 8, 1, "spans"), (1, 4, 8, 1, "pcts"), (1, 4, 8, 1, "out"),
     (1 << 20, 1 << 20, 8, 1, None)],
    ids=["negative_channels", "negative_frames", "negative_rows", "col_pool_0", "null_x", "null_num_frames",
         "null_spans", "null_pcts", "null_out", "grid_too_large"],
)
def test_kernel_entry_refuses_bad_arguments(lib, channels, frames, rows, col_pool, null):
    buf = torch.zeros(64)
    ptrs = dict.fromkeys(("x", "num_frames", "spans", "pcts", "out"), buf.data_ptr())
    if null is not None:
        ptrs[null] = None
    code = lib.aa_pool_image(ptrs["x"], ptrs["num_frames"], ptrs["spans"], ptrs["pcts"], ptrs["out"], channels,
                             frames, 16, 0, rows, col_pool, None)
    assert code != 0


def test_empty_call_is_a_no_op(lib):
    assert lib.aa_pool_image(None, None, None, None, None, 0, 4, 16, 0, 8, 1, None) == 0
    assert lib.aa_pool_image(None, None, None, None, None, 2, 4, 16, 0, 0, 1, None) == 0
