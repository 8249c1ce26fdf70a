"""The Karplus-Strong kernel's CUDA source (audio_analysis_tpu_torch/csrc/
karplus.cu, K3) run on the CPU against its plain torch version.

The source is compiled with g++ against tests/cuda_host/cuda_runtime.h
(tests/_cuda_host_build.py), so its four paths run here as written: one
thread a string (L <= 3: the period in registers), one warp (L <= 32: 3
periods a round from 3 shuffled neighbours), the register path (32 < L <=
8192: one warp of V = 2 or 4 registers a lane up to 128, then up to 32
warps of V = 2, 4 or 8 whose edges cross through shared memory and a
barrier a period) and the ring (L > 8192: the output read back from
memory, a barrier a period). What this cannot show (g++,
not nvcc: whether nvcc contracts an operation into a fused multiply-add;
no timing) is left to tests/test_torch_cuda.py and chip_smoke.py on the
card.

Tolerance: none. The kernel rounds every operation in the plain version's
order, so the samples must be bit-equal (compared as int32 bit patterns).
"""

import ctypes

import numpy as np
import pytest
import torch

from _cuda_host_build import build_host_library
from audio_analysis_tpu_torch.signals import torchgen

G, BLEND = 0.996, 0.5


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = build_host_library("karplus", 4, tmp_path_factory.mktemp("karplus_host"))
    p, i64, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    lib.aa_karplus.argtypes = [p, p, i64, i64, i64, f32, f32, p]
    lib.aa_karplus.restype = ctypes.c_int
    return lib


def _lines(strings: int, delay: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-1.0, 1.0, (strings, delay)).astype(np.float32))


def _host_karplus(lib, init: torch.Tensor, total: int, g: float = G, b: float = BLEND) -> torch.Tensor:
    """The kernel through its C entry on host memory, into a NaN-filled
    output, so a sample it never writes shows."""
    strings, delay = init.shape
    out = torch.full((strings, total), float("nan"))
    assert lib.aa_karplus(init.data_ptr(), out.data_ptr(), strings, delay, total, g, b, None) == 0
    return out


def _assert_bit_equal_to_plain(lib, init, total, g=G, b=BLEND):
    got = _host_karplus(lib, init, total, g, b)
    ref = torchgen.karplus_strong_batch_plain(init, total, g, b).contiguous()
    assert got.shape == ref.shape
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    return got


# every delay length of the kernel's paths near their edges: the one-thread
# path (2, 3; L = 1 below), the warp path's rounds of 3 periods (4-7, 12,
# 31, 32), the register path's one warp of V = 2 and 4 registers a lane
# (33-64, 65-128) and its 2-32 warps of V = 2, 4 and 8 (129-2048,
# 2049-4096, 4097-8192), the ring past it (8193), and the gen CLI's 4 kHz
# (12), 110 Hz (436) and 20 Hz (2400); six periods and a part of a seventh
@pytest.mark.parametrize("delay", [2, 3, 12, 31, 32, 33, 64, 436, 4, 5, 6, 7, 65, 128, 129, 2400, 4096, 4097,
                                   8192, 8193, 256, 257, 512, 513, 1024, 1025, 2048, 2049])
def test_kernel_source_bit_equal_to_plain(lib, delay):
    total = 6 * delay + max(1, delay // 3)
    assert total % delay != 0
    _assert_bit_equal_to_plain(lib, _lines(3, delay, delay), total)


@pytest.mark.parametrize("delay,total", [(12, 5), (33, 20), (12, 12)], ids=["warp", "block", "exactly_one_period"])
def test_total_no_longer_than_the_line_is_the_line(lib, delay, total):
    init = _lines(2, delay, 7)
    got = _assert_bit_equal_to_plain(lib, init, total)
    assert torch.equal(got, init[:, :total])


@pytest.mark.parametrize("delay", [12, 64, 300])
def test_total_a_multiple_of_the_delay(lib, delay):
    _assert_bit_equal_to_plain(lib, _lines(2, delay, 3), 9 * delay)


@pytest.mark.parametrize("delay", [12, 436])
def test_one_string(lib, delay):
    _assert_bit_equal_to_plain(lib, _lines(1, delay, 11), 4 * delay + 5)


@pytest.mark.parametrize("blend", [0.0, 1.0])
@pytest.mark.parametrize("delay", [12, 64])
def test_blend_at_its_ends(lib, delay, blend):
    """b = 0: a pure delay with decay; b = 1: the two-point average alone."""
    _assert_bit_equal_to_plain(lib, _lines(3, delay, delay + 1), 5 * delay + 7, b=blend)


@pytest.mark.parametrize("periods", [2, 7, 8, 12, 13])
@pytest.mark.parametrize("part", [0, 1, 11])
def test_a_round_that_ends_past_total(lib, periods, part):
    """L = 12 (rounds of 6 periods after the first period alone): totals
    whose last round stops after 1-6 of its periods, at a period's edge
    and inside one; every sample past total stays unwritten (the output
    is exactly total long)."""
    _assert_bit_equal_to_plain(lib, _lines(2, 12, periods + part), 12 * periods + part)


@pytest.mark.parametrize("delay", [2, 5])
def test_short_lines_over_many_rounds(lib, delay):
    """L = 2 and 5 (rounds of 2 and 4 periods), 300 periods: the halo's
    lanes wrap into the period before in every round."""
    _assert_bit_equal_to_plain(lib, _lines(3, delay, delay * 7), 300 * delay + 1)


def test_a_delay_of_one_sample(lib):
    """L = 1: lane 0's neighbour is its own value of the period before."""
    _assert_bit_equal_to_plain(lib, _lines(2, 1, 5), 40)


def test_decay_into_subnormals_and_zero(lib):
    """g = 0.5 over 300 periods takes the line below the smallest normal
    float and on to 0: both sides keep subnormals (no flush to zero)."""
    got = _assert_bit_equal_to_plain(lib, _lines(2, 3, 13), 900, g=0.5)
    tail = got[:, -3:].abs()
    assert bool((tail < 1.2e-38).all())


def test_many_periods_at_four_kilohertz(lib):
    """L = 12, 400 periods: the registers carry the line the whole way."""
    _assert_bit_equal_to_plain(lib, _lines(2, 12, 4000), 400 * 12 + 7)


def test_kernel_source_bit_equal_to_the_jax_scan(lib):
    """The kernel against the JAX package's compiled lax.scan that it
    replaces, on the same line."""
    pytest.importorskip("jax")
    from audio_analysis_tpu.signals import jaxgen

    init = _lines(3, 12, 21)
    total = 12 * 30 + 5
    ref = np.asarray(jaxgen.karplus_strong_batch(init.numpy(), total, G, BLEND))
    got = _host_karplus(lib, init, total).numpy()
    assert ref.shape == got.shape
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize(
    "strings,delay,total,null",
    [(-1, 12, 10, None), (1, 0, 10, None), (1, 12, -1, None), (1, 12, 10, "init"), (1, 12, 10, "out"),
     (1 << 31, 12, 10, None)],
    ids=["negative_strings", "no_delay", "negative_total", "null_init", "null_out", "grid_too_large"],
)
def test_kernel_entry_refuses_bad_arguments(lib, strings, delay, total, null):
    buf = torch.zeros(64)
    ptrs = {"init": buf.data_ptr(), "out": buf.data_ptr()}
    if null is not None:
        ptrs[null] = None
    assert lib.aa_karplus(ptrs["init"], ptrs["out"], strings, delay, total, G, BLEND, None) != 0


def test_empty_call_is_a_no_op(lib):
    assert lib.aa_karplus(None, None, 0, 12, 100, G, BLEND, None) == 0
    assert lib.aa_karplus(None, None, 3, 12, 0, G, BLEND, None) == 0
