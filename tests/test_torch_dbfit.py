"""`dbfit.fit_decay_ranges`, the engine's several-range decay fits, on the
CPU: there it is the plain version, one `fit_decay_slope_over_db_range` a
range, bit for bit, for random curves and for curves that corner the fits;
on a CUDA tensor it launches K5 (csrc/dbfit.cu) or raises, and never falls
back to the plain version (checked here with a stand-in tensor and the
kernel library replaced by one that fails if it is loaded). The kernel
itself is held to the plain version by tests/test_torch_dbfit_host.py
(its source on the CPU) and tests/test_torch_cuda.py (on the card).
"""

from unittest import mock

import numpy as np
import pytest
import torch

from _dbfit_compare import edge_curves
from audio_analysis_tpu_torch import _build
from audio_analysis_tpu_torch.ops import dbfit, edc

SR = 48_000
ENGINE_RANGES = ((-5.0, -35.0), (-5.0, -25.0), (0.0, -10.0))


def _random_curves(seed: int, shape, n: int):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = (rng.standard_normal((*shape, n)) * 10.0 ** (-3.0 * t / rng.uniform(0.05, 0.5, (*shape, 1)))).astype(np.float32)
    lengths = rng.integers(0, n + 1, shape).astype(np.int32)
    x[np.arange(n) >= lengths[..., None]] = 0.0
    lengths_t = torch.from_numpy(lengths)
    return edc.schroeder_edc_db_plain(torch.from_numpy(x), lengths_t), lengths_t


CURVES = {
    "random_2d": lambda: _random_curves(0, (5,), 12_000),
    "random_3d": lambda: _random_curves(1, (2, 3), 9_001),
    "edge_rows": lambda: edge_curves(4096 + 3),
}


@pytest.mark.parametrize("curves", sorted(CURVES))
@pytest.mark.parametrize(
    "ranges,fit_lower,sr,min_points",
    [(ENGINE_RANGES, -80.0, SR, 8), (((0.0, -10.0), (-5.0, -25.0), (-5.0, -35.0)), -80.0, SR / 4, 8),
     (((-5.0, -35.0), (-15.0, -45.0)), -40.0, SR, 20), (((-5.0, -25.0),), -80.0, SR, 8)],
    ids=["engine", "decimated", "lower_limit", "one_range"],
)
def test_fit_decay_ranges_on_cpu_is_the_per_range_fit_bit_for_bit(curves, ranges, fit_lower, sr, min_points):
    curve, lengths = CURVES[curves]()
    got = dbfit.fit_decay_ranges(curve, lengths, ranges, fit_lower, sr, min_points)
    assert len(got) == len(ranges)
    for fit, range_db in zip(got, ranges):
        ref = dbfit.fit_decay_slope_over_db_range(curve, lengths, range_db, fit_lower, sr, min_points)
        for name in ref._fields:
            a, b = getattr(fit, name), getattr(ref, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.equal(a, b), name


class _CudaStandIn:
    """What the wrapper reads of a CUDA tensor, without a card."""

    def __init__(self, dtype, contiguous: bool):
        self.device = torch.device("cuda", 0)
        self.dtype = dtype
        self._contiguous = contiguous

    def is_contiguous(self) -> bool:
        return self._contiguous


@pytest.mark.parametrize("dtype,contiguous", [(torch.float64, True), (torch.float16, True), (torch.float32, False)],
                         ids=["float64", "float16", "non_contiguous"])
def test_a_cuda_curve_the_kernel_does_not_take_raises_and_never_falls_back(dtype, contiguous):
    def no_library():
        raise AssertionError("the kernel library was loaded")

    lengths = torch.tensor([4096, 4096], dtype=torch.int32)
    before = dbfit.DBFIT_KERNEL.launches
    with mock.patch.object(_build, "library", no_library), \
            mock.patch.object(dbfit, "fit_decay_ranges_plain", side_effect=AssertionError("fell back")), \
            mock.patch.object(dbfit, "fit_decay_slope_over_db_range", side_effect=AssertionError("fell back")):
        with pytest.raises(TypeError, match="contiguous CUDA float32"):
            dbfit.fit_decay_ranges(_CudaStandIn(dtype, contiguous), lengths, ENGINE_RANGES, -80.0, SR)
    assert dbfit.DBFIT_KERNEL.launches == before


def test_the_kernel_wrapper_refuses_a_cpu_curve():
    curve, lengths = _random_curves(2, (2,), 4096)
    with pytest.raises(TypeError, match="contiguous CUDA float32"):
        dbfit.fit_decay_ranges_cuda(curve, lengths, ENGINE_RANGES, -80.0, SR)


@pytest.mark.parametrize("count", [0, dbfit.MAX_RANGES + 1])
def test_fit_decay_ranges_takes_one_to_max_ranges(count):
    curve, lengths = _random_curves(2, (2,), 4096)
    with pytest.raises(ValueError, match="ranges"):
        dbfit.fit_decay_ranges(curve, lengths, ((-5.0, -25.0),) * count, -80.0, SR)
