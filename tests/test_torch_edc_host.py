"""The EDC kernel's CUDA source (audio_analysis_tpu_torch/csrc/edc.cu) run
on the CPU against its plain torch version.

g++ compiles the .cu file as C++ against tests/cuda_host/cuda_runtime.h, a
stand-in for the CUDA subset the kernel uses: each CUDA thread of a block
is a std::thread, __syncthreads a barrier, a warp shuffle an exchange
between per-warp barriers, and blocks run one after another. So the
kernel's ticket order, its work items (tile totals and tile scans), the
16-byte and scalar paths, the in-tile suffix and the log epilogue run here
exactly as written. One spot of the source is rewritten textually, the
`<<<...>>>` launch; two host-only entries are appended (reverse block order,
and a launch that starts at a given ticket). What this cannot show (g++,
not nvcc; no concurrency between blocks, no caches, no timing) is left to
tests/test_torch_cuda.py and chip_smoke.py on the card.

Checks as on the card: within 0.02 dB of the plain version above -100 dB,
exactly 0 dB at index 0 and exactly 0 past `length`.
"""

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_analysis_tpu_torch.ops import edc

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "audio_analysis_tpu_torch" / "csrc" / "edc.cu"
HOST_INCLUDE = Path(__file__).resolve().parent / "cuda_host"
TILE = 4096

# the two launches (with and without row starts), the longer name first
_LAUNCHES = ("shifted_edc_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(",
             "edc_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(")
_HOST_ENTRIES = """
extern "C" void host_set_reverse_blocks(int on) { host_reverse_blocks = on != 0; }

// one block of the kernel on a zeroed scratch whose ticket counter starts
// at `ticket`
extern "C" int host_edc_from_ticket(const float* x, const int* lengths, float* scratch,
                                    float* out, long long rows, long long n, unsigned ticket) {
  const long long tiles = (n + kTile - 1) / kTile;
  unsigned long long* totals = reinterpret_cast<unsigned long long*>(scratch);
  unsigned* counter = reinterpret_cast<unsigned*>(totals + rows * tiles);
  std::memset(scratch, 0, rows * tiles * 8 + 4);
  *counter = ticket;
  host_launch(edc_kernel, 1u, kThreads, 0, x, lengths, totals, counter, out, (unsigned)rows, n,
              (unsigned)tiles, 1e-20f, -120.0f);
  return 0;
}
"""


@pytest.fixture(scope="module")
def lib_path(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    src = SOURCE.read_text()
    for launch in _LAUNCHES:
        assert src.count(launch) == 1, "kernel source changed shape"
        kernel = launch.split("<<<")[0]
        src = src.replace(launch, f"host_launch({kernel}, (unsigned)blocks, kThreads, 0, ")
    src += _HOST_ENTRIES
    out = tmp_path_factory.mktemp("edc_host")
    (out / "edc_host.cpp").write_text(src)
    so = out / "libedc_host.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", f"-I{HOST_INCLUDE}", "-o", str(so),
         str(out / "edc_host.cpp"), "-lpthread"],
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr
    return so


def _load(path):
    lib = ctypes.CDLL(str(path))
    p, i64, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    lib.aa_edc_db.argtypes = [p, p, p, p, p, i64, i64, f32, f32, p]
    lib.aa_edc_db.restype = ctypes.c_int
    lib.host_set_reverse_blocks.argtypes = [ctypes.c_int]
    lib.host_edc_from_ticket.argtypes = [p, p, p, p, i64, i64, ctypes.c_uint]
    return lib


@pytest.fixture(scope="module")
def lib(lib_path):
    return _load(lib_path)


def _host_edc(lib, x, lengths, reverse=False, floor_db=-120.0, starts=None):
    """The kernel through its C entry, on host memory, with the scratch
    ops/edc.py allocates (NaN-filled, so an unwritten read shows). With
    `starts`, `lengths` are the aligned lengths, as ops/edc.py passes them."""
    rows, n = x.shape
    tiles = -(-n // TILE)
    scratch = torch.full((2 * rows * tiles + 1,), float("nan"))
    out = torch.full((rows, n), float("nan"))
    lib.host_set_reverse_blocks(int(reverse))
    try:
        code = lib.aa_edc_db(
            x.data_ptr(), lengths.data_ptr(), None if starts is None else starts.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), rows, n, 1e-20, floor_db, None,
        )
    finally:
        lib.host_set_reverse_blocks(0)
    assert code == 0
    return out


def _decays(rows, n, seed, tau=None):
    """Decaying noise, as the engine's rows are: exp(-t/tau) envelopes."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    taus = rng.uniform(0.05, 1.0, (rows, 1)) * max(n, 8) if tau is None else np.full((rows, 1), tau)
    return (rng.standard_normal((rows, n)) * np.exp(-t / taus)).astype(np.float32)


def _assert_matches_plain(got, x, lengths, floor_db=-120.0):
    ref = edc.schroeder_edc_db_plain(x, lengths, edc_floor_db=floor_db)
    assert got.shape == ref.shape
    n = x.shape[-1]
    past = torch.arange(n)[None, :] >= lengths[:, None].long()
    assert bool((got[past] == 0).all()), "not exactly 0 past length"
    assert bool((got[:, 0] == 0).all()), "not exactly 0 dB at index 0"
    usable = (ref > -100.0) & ~past
    if bool(usable.any()):
        assert (got - ref).abs()[usable].max().item() <= 0.02
    assert bool(torch.isfinite(got).all())


# (n, rows, lengths as fractions of n or ints, storage offset in floats):
# single samples, one tile either side of 4096, several tiles plus one,
# 2^16; 1 to 5 rows (fewer and more than the kernel's lead of 3 rows);
# lengths of 0, 1, n and cuts mid-tile; a base one float into its storage
# and odd n (the scalar path)
CASES = [
    (1, 1, (1,), 0),
    (1, 3, (0, 1, 1), 0),
    (5, 2, (5, 3), 0),
    (4095, 2, (4095, 1), 1),
    (4096, 1, (4096,), 0),
    (4096, 4, (4096, 2048, 0, 4095), 0),
    (4097, 3, (4097, 4096, 1), 0),
    (3 * TILE + 1, 5, (3 * TILE + 1, 2 * TILE + 77, TILE, 1, 3 * TILE), 0),
    (3 * TILE + 1, 2, (3 * TILE + 1, 5000), 1),
    (1 << 16, 1, (1 << 16,), 0),
    (1 << 16, 4, (1 << 16, 40_000, 12_345, 65_535), 0),
    ((1 << 16) - 3, 2, ((1 << 16) - 3, 30_001), 2),
]


@pytest.mark.parametrize("n,rows,lengths,offset", CASES)
def test_kernel_source_matches_plain(lib, n, rows, lengths, offset):
    length = torch.tensor(lengths, dtype=torch.int32)
    signal = torch.from_numpy(_decays(rows, n, n + rows + offset))
    x = torch.zeros(offset + rows * n)[offset:].view(rows, n)
    x.copy_(torch.where(torch.arange(n)[None, :] < length[:, None].long(), signal, 0.0))
    got = _host_edc(lib, x, length)
    _assert_matches_plain(got, x, length)


# Row starts (the bands block's alignment read inside K1): (n, starts,
# original lengths, storage offset in floats). n a multiple of 4 puts each
# row's misalignment at start % 4 (0, 1, 2, 3: the 16-byte and the shifted
# 16-byte paths on whole tiles); an odd n gives neighbouring rows other
# misalignments; start 0, start >= length (aligned length 0), start = n,
# start past n, a negative start (clamped to 0, as shift_to does), lengths
# below n; a base one float into its storage (no shifted 16-byte loads:
# the scalar path).
STARTS_CASES = [
    (4 * TILE, (0, 1, 2, 3), (4 * TILE,) * 4, 0),
    (4 * TILE, (5, 4098, 7, 4095), (4 * TILE - 100, 4 * TILE, 3 * TILE + 5, 4 * TILE - 1), 0),
    (3 * TILE + 9, (0, 1, 2, 3, 5, 4097), (3 * TILE + 9, 3 * TILE, 3 * TILE + 9, 2 * TILE + 77, 9000, 3 * TILE), 0),
    (3 * TILE + 8, (3 * TILE, 3 * TILE + 8, 3 * TILE + 20, -3, 0), (3 * TILE - 5, 3 * TILE + 8, 3 * TILE + 8,
                                                                 2 * TILE, 0), 0),
    (2 * TILE + 4, (1, 2, 3), (2 * TILE + 4, 2 * TILE, TILE + 3), 1),
    (5, (1, 3, 0), (5, 4, 2), 0),
]


def _rows_with_starts(n, starts, lengths, offset, seed):
    """Decaying noise on each row's [start, length), NaN elsewhere, so any
    read outside the aligned segment shows in the curve."""
    rows = len(starts)
    signal = torch.from_numpy(_decays(rows, n, seed))
    idx = torch.arange(n)[None, :]
    st = torch.tensor(starts, dtype=torch.int64)[:, None].clamp(0, n)
    inside = (idx >= st) & (idx < torch.tensor(lengths, dtype=torch.int64)[:, None])
    x = torch.zeros(offset + rows * n)[offset:].view(rows, n)
    x.copy_(torch.where(inside, signal, float("nan")))
    return x


@pytest.mark.parametrize("n,starts,lengths,offset", STARTS_CASES)
def test_row_starts_equal_shift_then_kernel(lib, n, starts, lengths, offset):
    """Each row read from its start is bit-identical to ops/trim.py
    shift_to followed by the kernel without starts, in ticket order and
    with the blocks reversed."""
    from audio_analysis_tpu_torch.ops import trim

    x = _rows_with_starts(n, starts, lengths, offset, n + len(starts) + offset)
    start = torch.tensor(starts, dtype=torch.int32)
    length = torch.tensor(lengths, dtype=torch.int32)
    aligned = trim.shift_to(x, start, length)
    ref = _host_edc(lib, aligned.samples.contiguous(), aligned.length)
    for reverse in (False, True):
        got = _host_edc(lib, x, aligned.length, reverse=reverse, starts=start)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), f"reverse={reverse}"
    _assert_matches_plain(ref, aligned.samples, aligned.length)


def test_fast_decay_tail_is_not_a_difference(lib):
    """Energy that falls to about 1e-12 of the total by the end: a suffix
    formed as total - prefix would lose everything below about -70 dB."""
    n = 1 << 15
    x = torch.from_numpy(_decays(2, n, 5, tau=n / 13.8))
    length = torch.tensor([n, n - 1000], dtype=torch.int32)
    got = _host_edc(lib, x, length)
    ref = edc.schroeder_edc_db_plain(x, length)
    assert ref[0, n - 100].item() < -100.0  # the tail does reach the floor
    _assert_matches_plain(got, x, length)


def test_all_zero_row_takes_the_eps_path(lib):
    n = 3 * TILE + 5
    x = torch.from_numpy(_decays(3, n, 9))
    x[1] = 0.0
    length = torch.tensor([n, n, 100], dtype=torch.int32)
    got = _host_edc(lib, x, length)
    _assert_matches_plain(got, x, length)
    assert bool((got[1] == 0).all())  # eps / eps everywhere: 0 dB


def test_a_floor_of_minus_infinity_passes_the_unfloored_curve(lib):
    """A smoothed EDC (ops/edc.py, smoothing_window_samples > 1) calls the
    kernel with a floor of -inf and floors after the box filter: the
    kernel's fmaxf(curve, floor) then passes the eps-clamped curve through,
    finite, below -120 dB."""
    n = 1 << 15
    x = torch.from_numpy(_decays(2, n, 17, tau=n / 20.0))
    length = torch.tensor([n, n - 3000], dtype=torch.int32)
    got = _host_edc(lib, x, length, floor_db=-np.inf)
    _assert_matches_plain(got, x, length, floor_db=-np.inf)
    assert got[0].min().item() < -150.0


def test_blocks_in_reverse_order_give_the_same_curve(lib):
    """Tickets, not blockIdx, decide the work: the last block to be
    scheduled takes the first ticket."""
    n = 5 * TILE + 3
    x = torch.from_numpy(_decays(5, n, 13))
    length = torch.tensor([n, 4 * TILE, 17, n - 1, 0], dtype=torch.int32)
    forward = _host_edc(lib, x, length)
    backward = _host_edc(lib, x, length, reverse=True)
    assert torch.equal(forward.view(torch.int32), backward.view(torch.int32))
    _assert_matches_plain(backward, x, length)


def test_two_calls_are_bit_identical(lib):
    n = 2 * TILE + 999
    x = torch.from_numpy(_decays(4, n, 21))
    length = torch.tensor([n, n, 3000, 1], dtype=torch.int32)
    a = _host_edc(lib, x, length)
    b = _host_edc(lib, x, length)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize(
    "rows,n,null",
    [(1 << 40, TILE, None), (2, 1 << 50, None), (1, 8, "x"), (1, 8, "lengths"),
     (1, 8, "scratch"), (1, 8, "out"), (1, 8, "misaligned scratch")],
)
def test_kernel_entry_refuses_bad_arguments(lib, rows, n, null):
    """Sizes past the ticket counter's range, null pointers, and a scratch
    that cannot hold the 8-byte flagged totals."""
    buf = torch.zeros(64)
    lengths = torch.zeros(1, dtype=torch.int32)
    ptrs = {"x": buf.data_ptr(), "lengths": lengths.data_ptr(), "scratch": buf.data_ptr(),
            "out": buf.data_ptr()}
    if null == "misaligned scratch":
        ptrs["scratch"] = buf.data_ptr() + 4
    elif null is not None:
        ptrs[null] = None
    code = lib.aa_edc_db(ptrs["x"], ptrs["lengths"], None, ptrs["scratch"], ptrs["out"], rows, n,
                         1e-20, -120.0, None)
    assert code != 0


def test_empty_call_is_a_no_op(lib):
    assert lib.aa_edc_db(None, None, None, None, None, 0, 100, 1e-20, -120.0, None) == 0
    assert lib.aa_edc_db(None, None, None, None, None, 3, 0, 1e-20, -120.0, None) == 0


def test_wait_on_a_total_never_published_fails_in_bounded_time(lib_path):
    """A scan item whose row totals never arrive: the stand-in's spin-wait
    aborts after its bound, in a child process, instead of hanging."""
    code = (
        "import ctypes, sys, torch\n"
        f"sys.path.insert(0, {str(Path(__file__).resolve().parent)!r})\n"
        "from test_torch_edc_host import _load\n"
        f"lib = _load({str(lib_path)!r})\n"
        "x = torch.ones(1, 4096); out = torch.zeros(1, 4096); scratch = torch.zeros(3)\n"
        "lengths = torch.full((1,), 4096, dtype=torch.int32)\n"
        # rows 1, one tile: ticket 0 is the total, ticket 1 the scan
        "lib.host_edc_from_ticket(x.data_ptr(), lengths.data_ptr(), scratch.data_ptr(),\n"
        "                         out.data_ptr(), 1, 4096, 1)\n"
        "print('RETURNED')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"),
    )
    assert proc.returncode != 0 and "RETURNED" not in proc.stdout
    assert "spin-wait was never satisfied" in proc.stderr, proc.stderr
