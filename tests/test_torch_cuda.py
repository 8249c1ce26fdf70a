"""GPU-only copies of the kernel comparisons: each CUDA kernel of the port
against its plain torch version on the card, and the engine on the card
against the engine on the CPU. Marked `cuda`; every test skips where
torch.cuda.is_available() is false. JAX is not needed (the card's machine
has none). On the card:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances: EDC 0.02 dB above -100 dB, exact 0 past `length`; STFT
max |err| / max(ref) < 1e-5; engine flags and counts exact, metrics as in
tests/test_torch_engine.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from audio_analysis_tpu_torch.engine import EngineConfig, analyze_batch
from audio_analysis_tpu_torch.ops import edc, stft

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


def _decays(rows, n, seed):
    g = torch.Generator().manual_seed(seed)
    t = torch.arange(n, dtype=torch.float32)
    tau = 2000.0 + 60000.0 * torch.rand(rows, 1, generator=g)
    x = torch.randn(rows, n, generator=g) * torch.exp(-t / tau)
    lengths = torch.randint(1, n + 1, (rows,), generator=g, dtype=torch.int32)
    lengths[0] = n
    return torch.where(torch.arange(n) < lengths[:, None], x, 0.0), lengths


def _assert_edc_matches_plain(x, lengths):
    before = edc.EDC_KERNEL.launches
    got = edc.schroeder_edc_db(x, lengths).edc_db
    assert edc.EDC_KERNEL.launches == before + 1
    ref = edc.schroeder_edc_db_plain(x, lengths)
    n = x.shape[-1]
    past = torch.arange(n, device=x.device)[None, :] >= lengths[:, None]
    usable = (ref > -100.0) & ~past
    if bool(usable.any()):
        assert (got - ref).abs()[usable].max().item() <= 0.02
    assert bool((got[past] == 0).all()) and bool((got[:, 0] == 0).all())
    return got


# the octave and third-octave bands of one stereo tap are 18 and 52 rows
@pytest.mark.parametrize(
    "rows,n",
    [(64, 1 << 20), (16, (1 << 20) - 3 * 4096), (18, 1 << 20), (52, 1 << 20), (3, 4097), (2, 5), (3, 1)],
)
def test_edc_kernel_matches_plain(dev, rows, n):
    x, lengths = _decays(rows, n, rows + n)
    _assert_edc_matches_plain(x.to(dev), lengths.to(dev))


def test_edc_kernel_edge_rows(dev):
    """Lengths 0 and 1, an all-zero row (the eps path), and a fast decay
    whose tail is about 1e-12 of the total (suffixes never formed as
    total - prefix)."""
    n = 3 * 4096 + 7
    x, _ = _decays(5, n, 99)
    t = torch.arange(n, dtype=torch.float32)
    x[3] = torch.randn(n, generator=torch.Generator().manual_seed(4)) * torch.exp(-t / (n / 13.8))
    x[4] = 0.0
    lengths = torch.tensor([0, 1, n, n, n], dtype=torch.int32)
    x = torch.where(torch.arange(n) < lengths[:, None], x, 0.0)
    got = _assert_edc_matches_plain(x.to(dev), lengths.to(dev))
    assert bool((got[4] == 0).all())


def test_edc_kernel_two_calls_bit_identical(dev):
    x, lengths = _decays(48, 1 << 20, 11)
    x, lengths = x.to(dev), lengths.to(dev)
    a = edc.schroeder_edc_db(x, lengths).edc_db
    b = edc.schroeder_edc_db(x, lengths).edc_db
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _assert_stft_matches_plain(x, lengths, n_fft, hop, k_out):
    before = stft.STFT_KERNEL.launches
    res = stft.stft_magnitude(x, lengths, n_fft, hop, True, 1e-6, k_out)
    assert stft.STFT_KERNEL.launches == before + 1
    ref = stft.stft_magnitude_plain(x, lengths, n_fft, hop, True, 1e-6, k_out)
    assert res.mag.shape == ref.shape
    assert ((res.mag - ref).abs().max() / ref.abs().max()).item() < 1e-5
    assert torch.equal(res.mag == 0, ref == 0)


# every power-of-two n_fft the kernel takes (one template instance each),
# the main path's shapes, hops that are not a multiple of 4 (odd hops put
# every other frame start off 8-byte alignment: the scalar load path), and
# k_out of 1 and of n_fft/2 + 1
@pytest.mark.parametrize(
    "n_fft,hop,k_out",
    [
        (256, 64, 100),
        (256, 63, 129),
        (512, 96, None),
        (1024, 250, 1),
        (2048, 333, None),
        (4096, 512, None),
        (4096, 1024, None),
        (4096, 509, 2049),
        (8192, 512, 3415),
        (8192, 777, 1),
        (16384, 512, None),
        (16384, 1001, 5),
    ],
)
def test_stft_kernel_matches_plain(dev, n_fft, hop, k_out):
    g = torch.Generator().manual_seed(n_fft + hop)
    x = torch.randn(4, 1 << 18, generator=g).to(dev)
    # the last two lengths cut frames: only frames wholly inside survive
    lengths = torch.tensor([1 << 18, 100000, n_fft, n_fft - 1], dtype=torch.int32, device=dev)
    _assert_stft_matches_plain(x, lengths, n_fft, hop, k_out)


@pytest.mark.parametrize("view", ["offset", "strided"])
@pytest.mark.parametrize("n_fft,hop", [(4096, 512), (8192, 512), (256, 64)])
def test_stft_kernel_takes_views(dev, view, n_fft, hop):
    """A contiguous view one float into its storage (rows off 8-byte
    alignment) and a strided view (copied by the wrapper)."""
    g = torch.Generator().manual_seed(7)
    rows, n = 3, 50_001
    base = torch.randn(rows * n + 1, generator=g).to(dev)
    x = base[1:].view(rows, n) if view == "offset" else base[: rows * n].view(n, rows).t()
    assert x.is_contiguous() == (view == "offset")
    lengths = torch.tensor([n, 30_000, 20_000], dtype=torch.int32, device=dev)
    _assert_stft_matches_plain(x, lengths, n_fft, hop, None)


def test_engine_on_card_matches_cpu(dev):
    rng = np.random.default_rng(3)
    n = 1 << 16
    t = np.arange(n) / 48_000
    x = np.zeros((2, 2, n), np.float32)
    x[:, :, 256:] = 0.05 * rng.standard_normal((2, 2, n - 256)) * 10.0 ** (-3.0 * t[: n - 256] / 1.2)
    x[:, :, 256] = 0.9
    lengths = np.array([n, n - 9000], np.int32)
    x[1, :, n - 9000 :] = 0.0
    cfg = dataclasses.replace(EngineConfig(), band_mode="octave")
    got = analyze_batch(torch.from_numpy(x).to(dev), torch.from_numpy(lengths).to(dev), cfg)
    ref = analyze_batch(torch.from_numpy(x), torch.from_numpy(lengths), cfg)
    assert sorted(got) == sorted(ref)
    for key, value in ref.items():
        a, b = got[key].cpu().numpy(), value.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, key
        if key.endswith("_ok") or a.dtype == np.int32:
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            rtol = 1e-2 if key in ("modal_rt60", "modal_r2") else 1e-3
            np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-4, equal_nan=True, err_msg=key)
