"""The plain torch versions beside the port's two CUDA kernels, held against
the JAX package's Pallas kernels (interpret mode on the CPU) and its jnp
references.

K1: Schroeder EDC (ops/edc.py schroeder_edc_db_plain) vs
    ops/pallas_kernels.schroeder_edc_db_pallas and ops/edc.schroeder_edc_db.
    Tolerance 0.02 dB above -100 dB (below that the curve is a few float32
    ulps of the total and the accumulation order decides the last bits),
    exact 0 past `length`, monotone on a pure decay.
K2: STFT magnitude (ops/stft.py stft_magnitude_plain) vs
    ops/pallas_stft.stft_magnitude_pallas and ops/stft.stft_magnitude
    (fft_impl="xla"). Tolerance max |err| / max(ref) < 1e-5, the float32
    rounding of a 4096..8192-point FFT with margin.
"""

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from audio_analysis_tpu.ops import edc as jedc  # noqa: E402
from audio_analysis_tpu.ops import pallas_kernels, pallas_stft  # noqa: E402
from audio_analysis_tpu.ops import stft as jstft  # noqa: E402
from audio_analysis_tpu_torch.ops import edc, stft  # noqa: E402

torch.set_num_threads(2)

EDC_TOL_DB = 0.02
STFT_REL_TOL = 1e-5


def _cpu():
    return jax.default_device(jax.devices("cpu")[0])


def _decays(shape, n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    rows = int(np.prod(shape))
    tau = 2000.0 + 1500.0 * np.arange(rows).reshape(shape)[..., None]
    return (0.1 * rng.standard_normal(shape + (n,)) * np.exp(-t / tau)).astype(np.float32)


def _plain_edc(x, lengths):
    return edc.schroeder_edc_db_plain(torch.from_numpy(x), torch.from_numpy(lengths)).numpy()


def test_edc_plain_matches_pallas_interpret_and_jnp():
    n = 16384
    x = _decays((2, 2), n, 0)
    lengths = np.array([[n, n], [n // 2, n]], np.int32)
    x[1, 0, n // 2 :] = 0.0
    got = _plain_edc(x, lengths)
    with _cpu():
        pallas = np.asarray(
            pallas_kernels.schroeder_edc_db_pallas(
                jnp.asarray(x), jnp.asarray(lengths), interpret=True
            )
        )
        ref = np.asarray(jedc.schroeder_edc_db(jnp.asarray(x), jnp.asarray(lengths)).edc_db)
    for other in (pallas, ref):
        usable = other > -100.0
        np.testing.assert_allclose(got[usable], other[usable], atol=EDC_TOL_DB)
    assert np.all(got[1, 0, n // 2 :] == 0.0)
    assert np.all(got[..., 0] == 0.0)


def test_edc_plain_any_length_matches_jnp():
    """N that is no multiple of the Pallas tile (16384): the jnp side only."""
    n = 3 * 4096 + 1000
    x = _decays((3,), n, 1)
    lengths = np.array([n, 7000, 1], np.int32)
    for i, length in enumerate(lengths):
        x[i, length:] = 0.0
    got = _plain_edc(x, lengths)
    with _cpu():
        ref = np.asarray(jedc.schroeder_edc_db(jnp.asarray(x), jnp.asarray(lengths)).edc_db)
    usable = ref > -100.0
    np.testing.assert_allclose(got[usable], ref[usable], atol=EDC_TOL_DB)
    past = np.arange(n)[None, :] >= lengths[:, None]
    assert np.all(got[past] == 0.0)


def test_edc_plain_monotone_for_decay():
    n = 16384
    x = np.exp(-np.arange(n) / 2000.0).astype(np.float32)[None, :]
    got = _plain_edc(x, np.array([n], np.int32))[0]
    assert got[0] == 0.0
    assert np.all(np.diff(got[: n - 100]) <= 1e-3)


def _frames_ref(x, n_fft, hop):
    t = 1 + (x.shape[-1] - n_fft) // hop
    idx = np.arange(t)[:, None] * hop + np.arange(n_fft)[None, :]
    return np.abs(np.fft.rfft(x[..., idx] * np.hanning(n_fft), axis=-1))


@pytest.mark.parametrize("n_fft,hop", [(4096, 512), (8192, 512), (4096, 1024)])
def test_stft_plain_matches_pallas_interpret_and_xla(n_fft, hop):
    rng = np.random.default_rng(0)
    n = 1 << 15
    x = rng.standard_normal((2, n)).astype(np.float32)
    lengths = np.full((2,), n, np.int32)
    got = stft.stft_magnitude_plain(
        torch.from_numpy(x), torch.from_numpy(lengths), n_fft, hop, True, 0.0
    ).numpy()
    with _cpu():
        pallas = np.asarray(
            pallas_stft.stft_magnitude_pallas(jnp.asarray(x), n_fft, hop, True, interpret=True)
        )
        xla = np.asarray(
            jstft.stft_magnitude(
                jnp.asarray(x), jnp.asarray(lengths), n_fft, hop, True, 0.0, "xla"
            ).mag
        )
    ref = _frames_ref(x.astype(np.float64), n_fft, hop)
    for other in (pallas, xla, ref):
        assert got.shape == other.shape
        err = np.max(np.abs(got - other)) / np.max(other)
        assert err < STFT_REL_TOL, err


def test_stft_plain_k_out_floor_and_frame_mask_match_jax():
    """The modal block's call: k_out bin trim, floor, frames past the valid
    length zeroed, num_frames."""
    rng = np.random.default_rng(2)
    n, n_fft, hop, k_out, floor_lin = 1 << 15, 8192, 512, 3415, 1e-6
    x = rng.standard_normal((2, 2, n)).astype(np.float32)
    lengths = np.array([[n, 20000], [9000, 8191]], np.int32)
    res = stft.stft_magnitude(
        torch.from_numpy(x), torch.from_numpy(lengths), n_fft, hop, True, floor_lin, k_out
    )
    with _cpu():
        ref = jstft.stft_magnitude(
            jnp.asarray(x), jnp.asarray(lengths), n_fft, hop, True, floor_lin, "xla", k_out
        )
    ref_mag = np.asarray(ref.mag)
    got = res.mag.numpy()
    assert got.shape == ref_mag.shape == (2, 2, 1 + (n - n_fft) // hop, k_out)
    assert np.max(np.abs(got - ref_mag)) / np.max(ref_mag) < STFT_REL_TOL
    np.testing.assert_array_equal(res.num_frames.numpy(), np.asarray(ref.num_frames))
    np.testing.assert_array_equal(got == 0.0, ref_mag == 0.0)


@pytest.mark.parametrize("n_fft", [3000, 128, 32768])
def test_stft_sizes_not_yet_ported_raise(n_fft):
    """Sizes K2 has no instance for (not a power of two, or outside
    256..16384) go through the plain route and match the JAX package's
    jnp.fft path; K2's own entry refuses them."""
    assert not stft.kernel_takes(n_fft)
    rng = np.random.default_rng(n_fft)
    n = 1 << 16
    x = rng.standard_normal((1, n)).astype(np.float32)
    lengths = np.array([n - 777], np.int32)
    res = stft.stft_magnitude(torch.from_numpy(x), torch.from_numpy(lengths), n_fft, 512, True, 1e-6)
    with _cpu():
        ref = jstft.stft_magnitude(jnp.asarray(x), jnp.asarray(lengths), n_fft, 512, True, 1e-6, "xla")
    ref_mag = np.asarray(ref.mag)
    assert res.mag.shape == ref_mag.shape
    assert np.max(np.abs(res.mag.numpy() - ref_mag)) / np.max(ref_mag) < STFT_REL_TOL
    np.testing.assert_array_equal(res.num_frames.numpy(), np.asarray(ref.num_frames))
    with pytest.raises(ValueError, match="powers of two"):
        stft._check_n_fft(n_fft)
    assert stft.STFT_KERNEL.launches == 0


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel entry points take CUDA tensors only: the plain version is
    chosen by the dispatching wrapper, never swapped in by the kernel path."""
    x = torch.zeros((1, 8192))
    length = torch.tensor([8192], dtype=torch.int32)
    with pytest.raises(TypeError):
        edc.schroeder_edc_db_cuda(x, length)
    with pytest.raises(TypeError):
        stft.stft_magnitude_cuda(x, length, 4096, 512)
    assert edc.EDC_KERNEL.launches == 0 and stft.STFT_KERNEL.launches == 0
