"""The spectrogram's display pooling of the port
(audio_analysis_tpu_torch/ops/display.py pooled_log_freq_image) against
the JAX package's (audio_analysis_tpu/ops/display.py) on the same seeded
(C, T, F) dB planes.

- The pooled image is bit-equal: max is exact, and both sides quantise to
  the same 1/128-dB int16 fixed point. Covered: column pooling 1 and > 1,
  channels whose valid widths pool differently (one call per channel), a
  short tap in a large bucket, one channel, and rows narrower than a bin
  (the nearest-bin rows).
- The colour percentiles agree within one 1/128-dB step.
- Each row's two range-max entries, picked by index in the port, are the
  entries the JAX package's one-hot selection matrix selects; the port
  builds no selection matrix.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from audio_analysis_tpu.ops import display as jax_display  # noqa: E402
from audio_analysis_tpu_torch.ops import display  # noqa: E402

SR = 48_000

# (id, n_fft, frames, valid frames per channel, rows, cols)
CASES = [
    ("col_pool_1", 4096, 256, (256, 200), 120, 1200),
    ("col_pool_2_report_rows", 4096, 2048, (2048, 2048), 720, 1200),
    ("split_pools_10_13", 4096, 2048, (1500, 2048), 120, 160),
    ("split_pools_2_1", 4096, 256, (256, 200), 120, 160),
    ("short_tap_in_big_bucket", 4096, 2048, (150, 100), 120, 160),
    ("one_channel", 4096, 600, (600,), 720, 400),
    ("sub_bin_rows", 1024, 300, (300, 280), 720, 1200),
]


def _plane(seed: int, c: int, t: int, n_fft: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    plane = rng.uniform(-120.0, 0.0, (c, t, n_fft // 2 + 1)).astype(np.float32)
    # a few loud cells, so the maxima and the 99.5th percentile differ
    plane[:, rng.integers(0, t, 8), rng.integers(0, n_fft // 2, 8)] = 3.0
    return plane


@pytest.mark.parametrize("n_fft,t,valid,rows,cols", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_pooled_image_bit_equal_to_jax(n_fft, t, valid, rows, cols):
    mag = _plane(n_fft + t, len(valid), t, n_fft)
    f_min, f_max = 20.0, 20_000.0
    ours = display.pooled_log_freq_image(
        torch.from_numpy(mag), np.asarray(valid), n_fft, SR, f_min, f_max, rows=rows, cols=cols
    )
    theirs = jax_display.pooled_log_freq_image(
        jnp.asarray(mag), np.asarray(valid), n_fft, SR, f_min, f_max, rows=rows, cols=cols
    )
    for c in range(len(valid)):
        assert ours[0][c].dtype == np.float32 and ours[0][c].shape == theirs[0][c].shape
        np.testing.assert_array_equal(ours[0][c], theirs[0][c])
    np.testing.assert_allclose(ours[1], theirs[1], rtol=0, atol=1 / 128)
    np.testing.assert_allclose(ours[2], theirs[2], rtol=0, atol=1 / 128)


@pytest.mark.parametrize("n_fft,rows", [(4096, 720), (1024, 720), (8192, 120)])
def test_row_entries_are_the_one_hot_selection(n_fft, rows):
    f_min, f_max = 20.0, 20_000.0
    i0, i1 = display.freq_selection(n_fft, SR, f_min, f_max)
    assert (i0, i1) == jax_display.freq_selection(n_fft, SR, f_min, f_max)
    key = (n_fft, SR, i0, i1, f_min, f_max, rows)
    first, second, levels = display._log_row_select(*key)
    sel, jax_levels = jax_display._log_row_select(*key)
    assert levels == jax_levels
    assert first.dtype == np.int64 and first.shape == second.shape == (rows,)
    np.testing.assert_array_equal(np.argmax(sel[:rows], axis=1), first)
    np.testing.assert_array_equal(np.argmax(sel[rows:], axis=1), second)
    assert np.all(sel.sum(axis=1) == 1.0)
    dev_first, dev_second = display._row_index_on(key, torch.device("cpu"))
    assert dev_first.dtype == torch.int64 and tuple(dev_first.shape) == (rows,)
    assert not hasattr(display, "_SEL_DEVICE")
