"""The kernels' operation and byte counts, tied to the bounds the port's
bring-up recorded at these shapes (PERF.md's table of kernels): K1 0.040 ms
at 16 x 2^20, K2 0.100 ms at 16 rows of 2^20 at 4096/512, K4 9.2 us at the
report's pooling call."""

import pytest

from benchlib import spec

K1 = spec.roofline("k1")
K2 = spec.roofline("k2")
K4 = spec.roofline("k4")


def test_k1_at_16_by_2_20():
    assert K1.bound_s({"rows": 16, "n": 1 << 20}) * 1e3 == pytest.approx(0.040, abs=5e-4)
    nbytes, flops = K1.work(16, 1 << 20)
    assert nbytes / 3.35e12 > flops / 67e12  # bound by bytes


def test_k2_at_16_rows_4096_512():
    shape = {"rows": 16, "n": 1 << 20, "n_fft": 4096, "hop": 512, "bins": 2049}
    assert K2.frames(1 << 20, 4096, 512) == 2041
    assert K2.bound_s(shape) * 1e3 == pytest.approx(0.100, abs=5e-4)
    nbytes, flops = K2.work(**shape)
    assert nbytes / 3.35e12 > flops / 67e12


def test_k2_modal_instance_is_bound_by_bytes_too():
    shape = {"rows": 16, "n": 1 << 20, "n_fft": 8192, "hop": 512, "bins": 3414}
    assert K2.bound_s(shape) * 1e3 == pytest.approx(0.153, abs=2e-3)


def test_k4_at_the_reports_call():
    n_sel = K4.selected_bins(4096, 48000, 20.0, 20000.0)
    assert n_sel == 1705
    shape = {"channels": 2, "frames": 2041, "n_sel": n_sel, "rows": 720, "col_pool": 2}
    assert K4.bound_s(shape) * 1e6 == pytest.approx(9.2, abs=0.05)


@pytest.mark.parametrize("cell,bands", [("bundle64.three", 3), ("bundle64.third", 26)])
def test_bundle_work_is_the_calls_whatever_its_launches(cell, bands):
    """One bundle call's K1 and K2 work at the cell's sizes, and its bound:
    the same whether the work is counted whole or launch by launch as the
    engine splits it today (8 chunks of 8 taps; the bands in one K1 launch
    a chunk at 3 bands, a tap at a time beyond)."""
    c = spec.resolve(cell)
    entry = spec.entry("bundle").Entry(c, 1, "cpu", spec.ROOT / "build" / "unused")
    work = entry.kernel_work()
    n = 1155072
    assert work["k1"] == [{"rows": 128, "n": n}, {"rows": 128 * bands, "n": n}]
    assert [w["bins"] for w in work["k2"]] == [2049, 3414] and all(w["rows"] == 128 for w in work["k2"])
    k1 = [{"rows": 16, "n": n}] * 8
    k1 += [{"rows": 16 * bands, "n": n}] * 8 if bands == 3 else [{"rows": 2 * bands, "n": n}] * 64
    k2 = [dict(w, rows=16) for w in work["k2"] for _ in range(8)]
    for roof, whole, split in ((K1, work["k1"], k1), (K2, work["k2"], k2)):
        assert sum(roof.bound_s(w) for w in whole) == pytest.approx(sum(roof.bound_s(s) for s in split), rel=1e-9)
