"""The display pooling kernel's CUDA source (audio_analysis_tpu_torch/csrc/
pool.cu, K4) run on the CPU against its plain torch version.

The source is compiled with g++ against tests/cuda_host/cuda_runtime.h
(tests/_cuda_host_build.py) and called through its C entry with the
arguments ops/display.py's wrapper gives it: the plane, the valid frame
counts, the rows' bin ranges of `_log_row_spans`, the selection and a
scratch buffer of `aa_pool_scratch_bytes`. Its output, the image and the
colour percentiles that its radix selection finds, is held to
`_pooled_image_plain` (the shifted-maximum pyramid and a sort), whose
parity with the JAX package is tests/test_torch_display.py's, and on the
planes built to corner the selection (a floor that holds more than 5% of
the cells, +-0 at a percentile, non-finite cells, 0-2 valid cells, both
percentiles in one bucket) also to the JAX package's `_pooled_image_dev`
itself, transposed. What this cannot show (g++, not nvcc; no timing) is
left to tests/test_torch_cuda.py and chip_smoke.py on the card.

Tolerance: none. Max and the selection are exact and both quantise alike,
so the int16 image and its percentile column must be equal.
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
    lib = build_host_library("pool", 2, tmp_path_factory.mktemp("pool_host"))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.aa_pool_image.argtypes = [p, p, p, p, p, i64, i64, i64, i32, i32, i32, i32, p]
    lib.aa_pool_image.restype = i32
    lib.aa_pool_scratch_bytes.argtypes = [i64]
    lib.aa_pool_scratch_bytes.restype = i64
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
    of ops/display.py _pooled_image_cuda, into an output of -1s and a
    scratch buffer of 0xff bytes (the entry clears what it uses)."""
    c, t, f = plane.shape
    i0, i1, rows = key[2], key[3], key[6]
    spans = torch.from_numpy(display._log_row_spans(*key))
    scratch = torch.full((lib.aa_pool_scratch_bytes(c),), 0xFF, dtype=torch.uint8)
    out = torch.full((c, rows, -(-t // col_pool) + 1), -1, dtype=torch.int16)
    code = lib.aa_pool_image(plane.data_ptr(), num_frames.data_ptr(), spans.data_ptr(), scratch.data_ptr(),
                             out.data_ptr(), c, t, f, i0, i1 - i0, rows, col_pool, None)
    assert code == 0
    return out


def _jax_pool(plane: torch.Tensor, num_frames: torch.Tensor, key: tuple, col_pool: int) -> torch.Tensor:
    """The JAX package's compiled `_pooled_image_dev` on the same plane,
    (C, T'+1, rows) transposed to the port's (C, rows, T'+1)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from audio_analysis_tpu.ops import display as jax_display

    i0, i1, rows = key[2], key[3], key[6]
    sel, levels = jax_display._log_row_select(*key)
    out = jax_display._pooled_image_dev(jnp.asarray(plane.numpy()), jnp.asarray(num_frames.numpy().astype(np.int32)),
                                        jnp.asarray(sel), i0, i1, rows, levels, col_pool)
    return torch.from_numpy(np.array(out)).transpose(1, 2).contiguous()


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
            assert bool((got[c, :, :-1] == -32767).all())  # every cell the empty value
            assert bool((got[c, :, -1] == 0).all())  # NaN percentiles quantise to 0


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
     (1, 4, 8, 1, "num_frames"), (1, 4, 8, 1, "spans"), (1, 4, 8, 1, "scratch"), (1, 4, 8, 1, "out"),
     (1 << 31, 4, 8, 1, None), (1, 1 << 29, 8, 1, None), (1, 4, 1 << 16, 1, None)],
    ids=["negative_channels", "negative_frames", "negative_rows", "col_pool_0", "null_x", "null_num_frames",
         "null_spans", "null_scratch", "null_out", "grid_too_large", "counts_past_32_bits",
         "rows_past_shared_memory"],
)
def test_kernel_entry_refuses_bad_arguments(lib, channels, frames, rows, col_pool, null):
    buf = torch.zeros(64)
    ptrs = dict.fromkeys(("x", "num_frames", "spans", "scratch", "out"), buf.data_ptr())
    if null is not None:
        ptrs[null] = None
    code = lib.aa_pool_image(ptrs["x"], ptrs["num_frames"], ptrs["spans"], ptrs["scratch"], ptrs["out"], channels,
                             frames, 16, 0, 16, rows, col_pool, None)
    assert code != 0


@pytest.mark.parametrize("i0,n_sel", [(0, 0), (4, 13), (-1, 4)], ids=["empty", "past_the_bins", "negative_i0"])
def test_kernel_entry_refuses_a_selection_outside_the_bins(lib, i0, n_sel):
    buf = torch.zeros(64)
    p = buf.data_ptr()
    assert lib.aa_pool_image(p, p, p, p, p, 1, 4, 16, i0, n_sel, 8, 1, None) != 0


def test_empty_call_is_a_no_op(lib):
    assert lib.aa_pool_image(None, None, None, None, None, 0, 4, 16, 0, 16, 8, 1, None) == 0
    assert lib.aa_pool_image(None, None, None, None, None, 2, 4, 16, 0, 16, 0, 1, None) == 0


def _floor_at_rank(rng, n_cells: int, shift: int) -> np.ndarray:
    """Cells uniform over (-119, 0) dB and the floor, -120 dB, in exactly
    floor(r5) + 1 + shift of them: the 5th percentile's lower order
    statistic is then the floor's last cell and its upper one the first
    cell above (shift 0), both are floor cells (shift 1), or both lie
    above the floor (shift -1)."""
    r5 = np.float32(np.float32(5.0) / np.float32(100.0)) * np.float32(n_cells - 1)
    values = rng.uniform(-119.0, 0.0, n_cells).astype(np.float32)
    values[rng.permutation(n_cells)[: int(np.floor(r5)) + 1 + shift]] = -120.0
    return values


def _corner_plane(kind: str, t: int, f: int, i0: int, i1: int, valid: tuple) -> np.ndarray:
    """A (2, t, f) plane whose channel 0 corners the percentile selection;
    channel 1 is uniform noise."""
    rng = np.random.default_rng(len(kind))
    plane = rng.uniform(-120.0, 0.0, (2, t, f)).astype(np.float32)
    shape = plane[0, : valid[0], i0:i1].shape  # channel 0's valid selected cells
    n = shape[0] * shape[1]
    flat = plane[0, : valid[0], i0:i1].reshape(-1)  # a copy, written back below
    if kind == "floor_holds_60_percent":
        flat[rng.permutation(n)[: n * 6 // 10]] = -120.0
    elif kind.startswith("floor_at_the_rank"):
        flat[:] = _floor_at_rank(rng, n, int(kind.rsplit("_", 1)[1].replace("m", "-")))
    elif kind == "signed_zeros_at_p995":
        flat[:] = rng.uniform(-120.0, -1.0, n)
        top = rng.permutation(n)[: n // 40]
        flat[top[::2]] = 0.0
        flat[top[1::2]] = -0.0
    elif kind == "signed_zeros_at_p5":
        flat[:] = rng.uniform(1.0, 60.0, n)
        low = rng.permutation(n)[: n // 10]
        flat[low[::2]] = 0.0
        flat[low[1::2]] = -0.0
    elif kind == "non_finite_cells":
        cells = rng.permutation(n)
        flat[cells[: n // 10]] = np.nan
        flat[cells[n // 10 : n // 5]] = np.inf
        flat[cells[n // 5 : 3 * n // 10]] = -np.inf
    elif kind in ("one_valid_cell", "two_valid_cells", "no_finite_cell"):
        flat[:] = np.nan
        flat[rng.permutation(n)[: {"one_valid_cell": 1, "two_valid_cells": 2, "no_finite_cell": 0}[kind]]] = (
            rng.uniform(-90.0, -10.0, 2)[: {"one_valid_cell": 1, "two_valid_cells": 2, "no_finite_cell": 0}[kind]])
    elif kind == "both_percentiles_in_one_bucket":
        flat[:] = rng.uniform(-59.9, -59.1, n)  # 1.84-1.87 x 2^5: one 12-bit key prefix
    elif kind == "one_value_everywhere":
        flat[:] = -120.0
    else:
        raise ValueError(kind)
    plane[0, : valid[0], i0:i1] = flat.reshape(shape)
    return plane


CORNERS = ["floor_holds_60_percent", "floor_at_the_rank_0", "floor_at_the_rank_1", "floor_at_the_rank_m1",
           "signed_zeros_at_p995", "signed_zeros_at_p5", "non_finite_cells", "one_valid_cell", "two_valid_cells",
           "no_finite_cell", "both_percentiles_in_one_bucket", "one_value_everywhere"]


@pytest.mark.parametrize("kind", CORNERS)
def test_percentile_corners_equal_to_the_sort_and_to_jax(lib, kind):
    """The selection's corners, channel 0 cornered and channel 1 noise with
    fewer valid frames, column pooling 2: the int16 image and percentiles
    equal the plain version's (the sort) and the JAX package's. JAX's
    one-hot selection matmul turns a non-finite cell into NaN across its
    whole column (0 x inf, 0 x NaN), so where the valid region holds one
    only its percentile column is compared."""
    key = _key(256, 40)
    i0, i1 = key[2], key[3]
    valid = (1, 9) if kind in ("one_valid_cell", "two_valid_cells", "no_finite_cell") else (17, 11)
    plane = torch.from_numpy(_corner_plane(kind, 17, 129, i0, i1, valid))
    nf = torch.tensor(valid, dtype=torch.int64)
    got = _host_pool(lib, plane, nf, key, 2)
    assert torch.equal(got, display._pooled_image_plain(plane, nf, key, 2))
    theirs = _jax_pool(plane, nf, key, 2)
    if not all(bool(torch.isfinite(plane[c, :v]).all()) for c, v in enumerate(valid)):
        assert torch.equal(got[:, :2, -1], theirs[:, :2, -1])
    else:
        assert torch.equal(got, theirs)
    pct = got[0, :2, -1].tolist()
    if kind in ("floor_holds_60_percent", "floor_at_the_rank_1", "one_value_everywhere"):
        assert pct[1] == -120 * 128  # the 5th percentile is the floor
    if kind in ("floor_at_the_rank_0", "floor_at_the_rank_m1"):
        assert pct[1] > -120 * 128  # interpolated towards, or wholly above, the floor
    if kind in ("signed_zeros_at_p995", "signed_zeros_at_p5"):
        assert pct[0 if kind.endswith("p995") else 1] == 0
    if kind == "no_finite_cell":
        assert pct == [0, 0]  # NaN quantises to 0


@pytest.mark.parametrize("valid", [(17, 17), (17, 5), (3, 16)], ids=["equal", "split", "split_reversed"])
@pytest.mark.parametrize("col_pool", [1, 2, 3])
def test_wide_selection_in_chunks_equal_to_jax(lib, valid, col_pool):
    """n_fft 8192: 3,413 selected bins, more than one staged chunk of a
    frame, with rows that straddle a chunk's edge; the image and the
    percentiles against the plain version and the JAX package."""
    key = _key(8192, 120)
    plane = _plane(col_pool, 2, 17, 8192)
    nf = torch.tensor(valid, dtype=torch.int64)
    got = _host_pool(lib, plane, nf, key, col_pool)
    assert key[3] - key[2] > 2048
    assert torch.equal(got, display._pooled_image_plain(plane, nf, key, col_pool))
    assert torch.equal(got, _jax_pool(plane, nf, key, col_pool))
