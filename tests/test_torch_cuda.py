"""GPU-only copies of the kernel comparisons: each CUDA kernel of the port
against its plain torch version on the card, the engine on the card
against the engine on the CPU, the per-file analyses on the card against
the same call on the CPU, a mesh of two shards on the card against the
single-device run (bit-equal), the AR Gram in float32 on the card against a
float64 Gram on the card, Karplus-Strong on the card against the CPU, the
report suite's render jobs with the kernels against the plain versions on
the card (and its markdown against the golden report), and the
spectrogram's display pooling on the card against the CPU; K3
(Karplus-Strong) and K4 (the display pooling) against their plain
versions on the card, bit for bit; and the
engine step's CUDA graphs: a graph run bit-equal to the `eager()` run on a
2-chunk bundle and a mesh of two shards with the kernels' launches
unchanged, every step config captured after a warm step that makes no
synchronising call, and a capture that meets a host read raising; the
step's block markers (ops/marker.py) in order on every replayed chunk;
chunks of 16 interleaved channels split on the card against the planar
CPU run, and their graph runs bit-equal to eager() through one reused
ring of page-locked staging buffers; and K5 (the engine's decay fits) against its plain version at the
engine's shapes and on rows that corner the fits, with its launches on one
engine chunk of each band mode; K1 reading rows from their starts against
trim.shift_to and K1 without starts, bit for bit, the step's band outputs
against the route with each row aligned by slicing first
(tests/_band_route.py), K1/K5 launches with one
row-start launch a band plane, and no gather in the bands block.
Marked `cuda`; every test skips where torch.cuda.is_available() is false.
JAX is not needed (the card's machine has none). On the card:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances: EDC 0.02 dB above -100 dB, exact 0 past `length`; STFT
max |err| / max(ref) < 1e-5; engine flags and counts exact, metrics as in
tests/test_torch_engine.py; per-file summaries as in
tests/test_reference_parity.py (TOLERANCES), the z-plane as in
tests/parity_matrix.py; the AR Gram within 1e-5 relative Frobenius (float32
sums of up to 65536 products a chunk); Karplus-Strong identical (the same
float32 operations in the same order); render jobs within
tests/_render_jobs.py JOB_TOLERANCES; the pooled image bit-equal, its
percentiles within one 1/128-dB step; K5's crossing times, point counts
and flags bit-equal, its sums as tests/_dbfit_compare.py states.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

import golden_utils
import parity_matrix
from _render_jobs import RecordingPlotWorker, compare_jobs
from _ar_reference import ar_normal_equations_f64, relative_frobenius
from _dbfit_compare import assert_edge_rows_cornered, assert_fits_agree, edge_curves
from _summary_parity import assert_summaries_agree
from audio_analysis_tpu_torch import signals
from audio_analysis_tpu_torch.analyses import decay, filterplot, modalcloud, rt60bands, spectrogram, zplane
from audio_analysis_tpu_torch.analyses._common import FileDsp
from audio_analysis_tpu_torch.engine import (
    EngineConfig,
    analyze_batch,
    analyze_batch_sharded,
    analyze_bundle_pipelined,
    eager,
    make_mesh,
)
from audio_analysis_tpu_torch.engine import batch as batch_module
from audio_analysis_tpu_torch.engine import graphs
from audio_analysis_tpu_torch.engine.batch import band_masks
from audio_analysis_tpu_torch.ops import dbfit, display, edc, fftmask, spectral, stft
from audio_analysis_tpu_torch.signals import torchgen
from test_reference_parity import TOLERANCES

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


# the octave and third-octave bands of one stereo tap are 18 and 52 rows;
# with --bands-decimate a three-band chunk of 8 stereo taps gives
# (16, 2^15) and (16, 2^18) planes, and third-octave's smallest group of
# one tap (12, 2^14)
@pytest.mark.parametrize(
    "rows,n",
    [(64, 1 << 20), (16, (1 << 20) - 3 * 4096), (18, 1 << 20), (52, 1 << 20), (3, 4097), (2, 5), (3, 1),
     (16, 1 << 15), (16, 1 << 18), (12, 1 << 14)],
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


def _rows_from_starts(rows: int, n: int, seed: int, dev):
    """Rows of decaying noise on [start, length) and NaN elsewhere (a read
    outside the aligned segment shows), with starts cycling through every
    misalignment, 0, at and past the row's length and n, each row's start
    unlike its neighbours', and lengths at and below n."""
    g = torch.Generator().manual_seed(seed)
    cycle = [0, 1, 2, 3, 4097, 70_001, n, n - 1, 2, 5, None, 1_000_003]
    starts, lengths = [], []
    for r in range(rows):
        length = n if r % 3 == 0 else int(torch.randint(n // 2, n + 1, (1,), generator=g))
        start = cycle[r % len(cycle)]
        start = length + 1 if start is None else min(start, n)  # None: start past the length
        starts.append(start)
        lengths.append(length)
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    gd = torch.Generator(device=dev).manual_seed(seed)
    t = torch.arange(n, dtype=torch.float32, device=dev)
    tau = 2000.0 + 60000.0 * torch.rand(rows, 1, generator=gd, device=dev)
    x = torch.randn(rows, n, generator=gd, device=dev) * torch.exp(-t / tau)
    idx = torch.arange(n, device=dev)[None, :]
    inside = (idx >= start[:, None]) & (idx < length[:, None])
    return torch.where(inside, x, float("nan")), start, length


# the band rows of one stereo and one 16-channel third-octave tap at the
# bundle's padded length, a length off the 16-byte grid, and a short one
@pytest.mark.parametrize("rows", [52, 416])
@pytest.mark.parametrize("n", [1_155_072, (1 << 20) + 3, 4097])
def test_edc_kernel_row_starts_equal_shift_then_kernel(dev, rows, n):
    from audio_analysis_tpu_torch.ops import trim

    x, start, length = _rows_from_starts(rows, n, rows + n, dev)
    aligned = trim.shift_to(x, start, length)
    ref = edc.schroeder_edc_db(aligned.samples, aligned.length)
    del aligned
    before = (edc.EDC_KERNEL.launches, edc.EDC_SHIFTED.launches)
    got = edc.schroeder_edc_db(x, length, start=start)
    assert (edc.EDC_KERNEL.launches - before[0], edc.EDC_SHIFTED.launches - before[1]) == (1, 1)
    assert torch.equal(got.length, ref.length)
    assert torch.equal(got.edc_db.view(torch.int32), ref.edc_db.view(torch.int32))


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


def test_mesh_on_card_equals_single_device(dev):
    """Two shards on one card: each runs the batch a single-device chunk
    would, through both kernels (K1 and K2 twice a shard), so the sharded
    results are bit-equal to the single-device run's, through
    analyze_batch_sharded and the pipelined entry alike."""
    rng = np.random.default_rng(4)
    n = 1 << 16
    t = np.arange(n) / 48_000
    x = np.zeros((4, 2, n), np.float32)
    x[:, :, 256:] = 0.05 * rng.standard_normal((4, 2, n - 256)) * 10.0 ** (-3.0 * t[: n - 256] / 1.2)
    x[:, :, 256] = 0.9
    lengths = np.array([n, n - 9000, n - 100, n - 4096], np.int32)
    mesh = make_mesh(devices=[dev, dev])
    single = analyze_bundle_pipelined(lambda lo, hi: x[lo:hi], lengths, n, EngineConfig(), 2, device=dev)
    edc.EDC_KERNEL.launches = stft.STFT_KERNEL.launches = 0
    piped = analyze_bundle_pipelined(lambda lo, hi: x[lo:hi], lengths, n, EngineConfig(), 2, mesh=mesh)
    assert (edc.EDC_KERNEL.launches, stft.STFT_KERNEL.launches) == (4, 4)
    sharded = analyze_batch_sharded(mesh, x, lengths, EngineConfig())
    assert float(sharded["bundle_median_t30"]) == pytest.approx(np.median(single["t30_rt60"][single["t30_ok"]]), rel=1e-6)
    for key, value in single.items():
        np.testing.assert_array_equal(piped[key], value, err_msg=key)
        np.testing.assert_array_equal(sharded[key].cpu().numpy(), value, err_msg=key)


@pytest.mark.parametrize("band_mode", ["three", "third"])
def test_decimated_engine_kernels_match_plain_on_card(dev, band_mode):
    """analyze_batch(bands_decimate=True) on the card through the kernels,
    against the same call with the plain versions swapped in: K1 launches
    once for the broadband decay and once per decimation group (per tap in
    third-octave mode), and K5 once after each."""
    rng = np.random.default_rng(5)
    n = 1 << 18
    t = np.arange(n) / 48_000
    x = np.zeros((2, 2, n), np.float32)
    x[:, :, 256:] = 0.05 * rng.standard_normal((2, 2, n - 256)) * 10.0 ** (-3.0 * t[: n - 256] / 1.2)
    x[:, :, 256] = 0.9
    lengths = np.array([n, n - 9000], np.int32)
    x[1, :, n - 9000 :] = 0.0
    cfg = dataclasses.replace(EngineConfig(), band_mode=band_mode, bands_decimate=True)
    groups = len(set(fftmask.band_decimation_factors(band_masks(cfg, n), n)))
    assert groups > 1
    xs, ls = torch.from_numpy(x).to(dev), torch.from_numpy(lengths).to(dev)
    before = (edc.EDC_KERNEL.launches, dbfit.DBFIT_KERNEL.launches)
    got = analyze_batch(xs, ls, cfg)
    k1 = 1 + groups * (1 if band_mode == "three" else 2)
    assert (edc.EDC_KERNEL.launches - before[0], dbfit.DBFIT_KERNEL.launches - before[1]) == (k1, k1)
    with mock.patch.object(edc, "schroeder_edc_db_cuda", edc.schroeder_edc_db_plain), \
            mock.patch.object(stft, "stft_magnitude_cuda", stft.stft_magnitude_plain), \
            mock.patch.object(dbfit, "fit_decay_ranges_cuda", dbfit.fit_decay_ranges_plain):
        ref = analyze_batch(xs, ls, cfg)
    for key, value in ref.items():
        a, b = got[key].cpu().numpy(), value.cpu().numpy()
        if key.endswith("_ok") or a.dtype == np.int32:
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            rtol = 1e-2 if key in ("modal_rt60", "modal_r2") else 1e-3
            np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-4, equal_nan=True, err_msg=key)


# case -> (analysis, settings, summary, tolerance row, K1 and K2 launches)
PER_FILE = {
    "decay": (decay.analyse_decay_channels, decay.DecayAnalysisSettings(compute_edt=True),
              decay.summarise_decay_results_text, "decay", (1, 0)),
    "decay_smoothing_480": (decay.analyse_decay_channels, decay.DecayAnalysisSettings(edc_smoothing_window_samples=480),
                            decay.summarise_decay_results_text, "decay", (1, 0)),
    "rt60bands": (rt60bands.analyse_rt60_bands_channels, rt60bands.Rt60BandsAnalysisSettings(include_t20=True),
                  lambda r: rt60bands.summarise_rt60_bands_results_text(r, True, False), "rt60bands", (1, 0)),
    "rt60bands_third": (rt60bands.analyse_rt60_bands_channels, rt60bands.Rt60BandsAnalysisSettings(band_mode="third"),
                        lambda r: rt60bands.summarise_rt60_bands_results_text(r, False, False), "rt60bands", (1, 0)),
    "spectrogram": (spectrogram.analyse_spectrogram_channels, spectrogram.SpectrogramAnalysisSettings(),
                    spectrogram.summarise_spectrogram_results_text, "spectrogram", (0, 1)),
    "spectrogram_n_fft_3000": (spectrogram.analyse_spectrogram_channels,
                               spectrogram.SpectrogramAnalysisSettings(n_fft=3000),
                               spectrogram.summarise_spectrogram_results_text, "spectrogram", (0, 0)),
    "modalcloud": (modalcloud.analyse_modal_cloud_channels, modalcloud.ModalCloudAnalysisSettings(),
                   modalcloud.summarise_modal_cloud_results_text, "modalcloud", (0, 1)),
    "filter": (filterplot.analyse_filter_response_channels, filterplot.FilterAnalysisSettings(),
               filterplot.summarise_filter_response_results_text, "filterplot", (0, 0)),
    "filter_radians_no_unwrap": (filterplot.analyse_filter_response_channels,
                                 filterplot.FilterAnalysisSettings(phase_mode="radians", unwrap_phase=False),
                                 filterplot.summarise_filter_response_results_text, "filterplot", (0, 0)),
    "zplane_order16": (zplane.analyse_zplane_channels, zplane.ZPlaneAnalysisSettings(ar_order=16),
                       zplane.summarise_zplane_results_text, (2e-2, 5e-3), (0, 0)),
    "zplane_order32_ridge_zeros": (zplane.analyse_zplane_channels,
                                   zplane.ZPlaneAnalysisSettings(ar_order=32, ridge_lambda=1e-5, derive_zeros=True,
                                                                 zero_order=16),
                                   zplane.summarise_zplane_results_text, (8e-2, 5e-3), (0, 0)),
}


def _golden_dsp(device, case: str = "") -> FileDsp:
    # the z-plane fits run on the matrix's damped IR (poles well inside the
    # unit circle; tests/parity_matrix.make_damped_ir)
    ir = parity_matrix.make_damped_ir() if case.startswith("zplane") else golden_utils.make_golden_ir()
    return FileDsp([("left", ir[:, 0]), ("right", ir[:, 1])], 48_000, device)


@pytest.mark.parametrize("case", sorted(PER_FILE))
def test_per_file_analysis_on_card_matches_cpu(dev, case):
    """The golden IR through one analysis on the card (K1 / K2 launched as
    many times as listed, K2 not at all at n_fft 3000) and on the CPU."""
    analyse, settings, summarise, tolerance, launches = PER_FILE[case]
    before = (edc.EDC_KERNEL.launches, stft.STFT_KERNEL.launches)
    got = summarise(analyse(_golden_dsp(dev, case), settings))
    assert (edc.EDC_KERNEL.launches - before[0], stft.STFT_KERNEL.launches - before[1]) == launches
    ref = summarise(analyse(_golden_dsp("cpu", case), settings))
    assert_summaries_agree(ref, got, *(TOLERANCES[tolerance] if isinstance(tolerance, str) else tolerance), case)


@pytest.mark.parametrize("n_fft", [3000, 32768])
def test_stft_sizes_outside_the_kernel_take_the_plain_route_on_card(dev, n_fft):
    x = torch.randn(2, 1 << 17, generator=torch.Generator().manual_seed(n_fft))
    lengths = torch.tensor([1 << 17, 100_000], dtype=torch.int32)
    before = stft.STFT_KERNEL.launches
    got = stft.stft_mag_db(x.to(dev), lengths.to(dev), n_fft, 512)
    assert stft.STFT_KERNEL.launches == before
    ref = stft.stft_mag_db(x, lengths, n_fft, 512)
    a, b = got.mag_db.cpu(), ref.mag_db
    assert a.shape == b.shape and torch.equal(got.num_frames.cpu(), ref.num_frames)
    loud = b > b.max() - 80.0
    assert (a - b).abs()[loud].max().item() <= 0.01


@pytest.mark.parametrize("channels,n,order", [(2, 1 << 20, 256), (1, 100_000, 64), (2, 4096, 300)])
def test_ar_gram_on_card_matches_float64_on_card(dev, channels, n, order):
    """The float32 Gram and moment of a decaying-noise segment (the last
    channel cut short) against float64 ones built by index gather, both on
    the card."""
    g = torch.Generator().manual_seed(n + order)
    t = torch.arange(n, dtype=torch.float32) / 48_000
    x = torch.randn(channels, n, generator=g) * torch.pow(10.0, -3.0 * t / 1.2)
    lengths = torch.full((channels,), n, dtype=torch.int32)
    lengths[-1] = n - n // 3
    x = torch.where(torch.arange(n) < lengths[:, None], x, 0.0).to(dev)
    lengths = lengths.to(dev)
    got = spectral.ar_normal_equations(x, lengths, order)
    assert got.gram.device.type == "cuda" and got.gram.dtype == torch.float32
    gram, moment = ar_normal_equations_f64(x, lengths, order)
    assert relative_frobenius(got.gram, gram) <= 1e-5
    assert relative_frobenius(got.moment[:, None, :], moment[:, None, :]) <= 1e-4


@pytest.mark.parametrize("freq", [110.0, 4000.0])
def test_karplus_strong_on_card_equals_cpu(dev, freq):
    got = signals.generate_karplus_strong_pluck(fundamental_frequency_hz=freq, duration_seconds=0.5, device=dev)
    ref = signals.generate_karplus_strong_pluck(fundamental_frequency_hz=freq, duration_seconds=0.5, device="cpu")
    assert got.samples.dtype == np.float32 and np.array_equal(got.samples, ref.samples)


@pytest.mark.parametrize("strings", [1, 8])
@pytest.mark.parametrize("delay", [1, 2, 12, 31, 32, 33, 436, 2400, 3, 4, 7, 64, 65, 129, 257, 513, 1024, 1025, 8192,
                                   8193])
def test_karplus_kernel_bit_equal_to_plain_on_card(dev, delay, strings):
    """K3 (one launch) against its plain version on the card and on the
    CPU: half a second of audio and a part period, bit for bit."""
    rng = np.random.default_rng(delay + strings)
    init = torch.from_numpy(rng.uniform(-1.0, 1.0, (strings, delay)).astype(np.float32))
    total = 24_000 + delay // 2 + 1 if delay > 1 else 24_000
    before = torchgen.KARPLUS_KERNEL.launches
    got = torchgen.karplus_strong_batch(init.to(dev), total, 0.996, 0.5)
    assert torchgen.KARPLUS_KERNEL.launches == before + 1
    ref = torchgen.karplus_strong_batch_plain(init.to(dev), total, 0.996, 0.5).contiguous()
    cpu = torchgen.karplus_strong_batch_plain(init, total, 0.996, 0.5).contiguous()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(got.cpu().view(torch.int32), cpu.view(torch.int32))


def test_report_render_jobs_on_card_match_plain(dev, tmp_path):
    """The golden IR's report on the card: K1 and K2 launched twice each,
    every render job within its tolerance of the plain versions' run on the
    card, the markdown against the golden report. Figures recorded, not
    drawn (no matplotlib needed)."""
    from audio_analysis_tpu_torch.io.wav import write_wav_pcm16
    from audio_analysis_tpu_torch.report.report import ReportSettings, run_report_from_wav_file

    wav = tmp_path / "golden_ir.wav"
    write_wav_pcm16(wav, golden_utils.make_golden_ir(), golden_utils.SR)
    kernel_jobs, plain_jobs = RecordingPlotWorker(), RecordingPlotWorker()
    edc.EDC_KERNEL.launches = stft.STFT_KERNEL.launches = 0
    ours = run_report_from_wav_file(wav, tmp_path / "k" / "golden", ReportSettings(), kernel_jobs, dev)
    assert (edc.EDC_KERNEL.launches, stft.STFT_KERNEL.launches) == (2, 2)
    with mock.patch.object(edc, "schroeder_edc_db_cuda", edc.schroeder_edc_db_plain), \
            mock.patch.object(stft, "stft_magnitude_cuda", stft.stft_magnitude_plain):
        plain = run_report_from_wav_file(wav, tmp_path / "p" / "golden", ReportSettings(), plain_jobs, dev)
    assert all(v <= 1.0 for v in compare_jobs(plain_jobs.jobs, kernel_jobs.jobs).values())
    golden_utils.compare_reports(plain.summary_markdown, ours.summary_markdown)
    golden_utils.compare_reports((golden_utils.GOLDEN_DIR / "verb_report_golden.md").read_text(), ours.summary_markdown)


@pytest.mark.parametrize("valid", [(2041, 2041), (2041, 900)], ids=["report_shape", "split_pools"])
def test_pooled_image_on_card_equals_cpu(dev, valid):
    rng = np.random.default_rng(5)
    plane = torch.from_numpy(rng.uniform(-120.0, 0.0, (2, 2041, 2049)).astype(np.float32))
    args = (np.asarray(valid), 4096, 48_000, 20.0, 20_000.0)
    card = display.pooled_log_freq_image(plane.to(dev), *args)
    cpu = display.pooled_log_freq_image(plane, *args)
    for a, b in zip(card[0], cpu[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(card[1], cpu[1], rtol=0, atol=1 / 128)
    np.testing.assert_allclose(card[2], cpu[2], rtol=0, atol=1 / 128)


@pytest.mark.parametrize("valid,col_pool", [((2041, 2041), 2), ((2041, 900), 1), ((301, 0), 3)],
                         ids=["report_shape", "col_pool_1", "valid_zero"])
def test_pool_kernel_equal_to_plain_on_card(dev, valid, col_pool):
    """K4 (one count of its wrapper: a memset and three launches) against
    its plain version on the same card plane: the int16 image and its
    percentile column equal."""
    rng = np.random.default_rng(7)
    plane = torch.from_numpy(rng.uniform(-120.0, 0.0, (2, 2041, 2049)).astype(np.float32)).to(dev)
    nf = torch.tensor(valid, dtype=torch.int64, device=dev)
    i0, i1 = display.freq_selection(4096, 48_000, 20.0, 20_000.0)
    key = (4096, 48_000, i0, i1, 20.0, 20_000.0, 720)
    before = display.POOL_KERNEL.launches
    got = display._pooled_image(plane, nf, key, col_pool)
    assert display.POOL_KERNEL.launches == before + 1
    assert torch.equal(got, display._pooled_image_plain(plane, nf, key, col_pool))


@pytest.mark.parametrize("kind", ["floor_60_percent", "signed_zeros_at_p995", "non_finite", "one_value"])
def test_pool_kernel_percentile_corners_on_card(dev, kind):
    """K4 against its plain version (the pyramid and a sort) on report-size
    planes whose channel 0 corners the radix selection: a -120 dB floor in
    60% of the cells, +-0 at the 99.5th percentile, NaN and +-inf cells,
    one value everywhere; the int16 image and percentiles equal."""
    rng = np.random.default_rng(11)
    plane = rng.uniform(-120.0, 0.0, (2, 2041, 2049)).astype(np.float32)
    region = plane[0]
    if kind == "floor_60_percent":
        region[rng.random(region.shape) < 0.6] = -120.0
    elif kind == "signed_zeros_at_p995":
        np.minimum(region, -0.5, out=region)
        cells = rng.random(region.shape)
        region[cells < 0.01] = 0.0
        region[(cells >= 0.01) & (cells < 0.02)] = -0.0
    elif kind == "non_finite":
        cells = rng.random(region.shape)
        region[cells < 0.01] = np.nan
        region[(cells >= 0.01) & (cells < 0.02)] = np.inf
        region[(cells >= 0.02) & (cells < 0.03)] = -np.inf
    else:
        region[:] = -120.0
    plane = torch.from_numpy(plane).to(dev)
    nf = torch.tensor((2041, 1500), dtype=torch.int64, device=dev)
    i0, i1 = display.freq_selection(4096, 48_000, 20.0, 20_000.0)
    key = (4096, 48_000, i0, i1, 20.0, 20_000.0, 720)
    got = display._pooled_image(plane, nf, key, 2)
    assert torch.equal(got, display._pooled_image_plain(plane, nf, key, 2))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernels_match_the_float64_oracle_at_drawn_shapes(dev, seed):
    """K1 and K2 on the card against the port's float64 oracle at drawn
    shapes: K1 within tests/test_edc_precision.py's 0.02 dB wherever the
    oracle's curve is at or above -80 dB (no trim, drawn eps and floor),
    0 past `length`; K2 within 1e-5 of the oracle's largest magnitude at a
    drawn instance, hop, k_out, floor and window."""
    from audio_analysis_tpu_torch import oracle

    rng = np.random.default_rng(seed)
    n = int(rng.choice([4095, 16385, 1 << 18, (1 << 20) - 3]))
    rows = int(rng.integers(2, 9))
    lengths = rng.integers(4, n + 1, rows).astype(np.int32)
    lengths[0] = n
    eps = float(rng.choice([1e-30, 1e-20, 1e-12]))
    floor = float(rng.choice([-120.0, -60.0, -np.inf]))
    x = (rng.standard_normal((rows, n)) * np.exp(-np.arange(n) / rng.uniform(100.0, n, (rows, 1)))).astype(np.float32)
    x[np.arange(n)[None, :] >= lengths[:, None]] = 0.0
    got = edc.schroeder_edc_db_cuda(torch.from_numpy(x).to(dev), torch.from_numpy(lengths).to(dev), eps, floor).cpu().numpy()
    for row, length in enumerate(lengths):
        assert np.all(got[row, length:] == 0.0)
        _, ref, _ = oracle.schroeder_edc_db(x[row, :length].astype(np.float64), 48_000, False, 0.0, eps, floor)
        region = ref >= -80.0
        np.testing.assert_allclose(got[row, :length][region], ref[region], atol=0.02)

    n_fft = int(rng.choice([256, 512, 1024, 2048, 4096, 8192, 16384]))
    hop = int(rng.integers(n_fft // 8, n_fft + 1))
    n = n_fft + 40 * hop
    k_out = int(rng.integers(1, n_fft // 2 + 2))
    floor_db = float(rng.choice([-200.0, -120.0, -60.0]))
    hann = bool(seed % 2 == 0)
    x = rng.standard_normal((2, n)).astype(np.float32) * np.exp(-np.arange(n) / n).astype(np.float32)
    lengths = np.array([n, n_fft + 7 * hop], np.int32)
    x[1, lengths[1]:] = 0.0
    got = stft.stft_magnitude_cuda(torch.from_numpy(x).to(dev), torch.from_numpy(lengths).to(dev), n_fft, hop, hann,
                                   10.0 ** (floor_db / 20.0), k_out).cpu().numpy()
    for row, length in enumerate(lengths):
        _, _, ref_db = oracle.stft_magnitude_db(x[row, :length].astype(np.float64), 48_000, n_fft, hop, hann, floor_db)
        ref = 10.0 ** (ref_db[:k_out].T / 20.0)
        assert np.max(np.abs(got[row, : ref.shape[0]] - ref)) <= 1e-5 * ref.max()
        assert np.all(got[row, ref.shape[0]:] == 0.0)


def _graph_taps(taps: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48_000
    x = np.zeros((taps, 2, n), np.float32)
    x[:, :, 256:] = 0.05 * rng.standard_normal((taps, 2, n - 256)) * 10.0 ** (-3.0 * t[: n - 256] / 1.2)
    x[:, :, 256] = 0.9
    lengths = (n - 4096 * np.arange(taps)).astype(np.int32)
    for i, length in enumerate(lengths):
        x[i, :, length:] = 0.0
    return x, lengths


def test_graph_runs_bit_equal_to_eager_on_a_bundle_and_a_mesh(dev, monkeypatch):
    """4 taps in chunks of 2 through the step's CUDA graphs: a first call
    (both chunks eager: one call of the key ahead is below
    MIN_CALLS_AHEAD), a second (the key ended the first: its first chunk
    eager, then captured, the second a replay), a warm call (two replays),
    a mesh of two shards on cuda:0 (one replay a shard), and a first call
    of a cache that captures with one call ahead (eager, captured,
    replayed). Each is bit-equal to the eager() run and launches K1 and K2
    4 and 4, as the eager run does."""
    n = 1 << 16
    x, lengths = _graph_taps(4, n, 6)
    mesh = make_mesh(devices=[dev, dev])

    def run(**kwargs):
        return analyze_bundle_pipelined(lambda lo, hi: x[lo:hi], lengths, n, EngineConfig(), 2, device=dev, **kwargs)

    with eager():
        ref = run()
    cache = graphs.StepGraphs()
    monkeypatch.setattr(graphs, "STEP_GRAPHS", cache)
    runs = (("first", {}, (0, 0)), ("second", {}, (1, 1)), ("warm", {}, (0, 2)), ("mesh", {"mesh": mesh}, (0, 2)),
            ("ahead", {}, (1, 1)))
    for label, kwargs, expected in runs:
        if label == "ahead":
            cache.clear()
            cache = graphs.StepGraphs(min_calls_ahead=1)
            monkeypatch.setattr(graphs, "STEP_GRAPHS", cache)
        edc.EDC_KERNEL.launches = stft.STFT_KERNEL.launches = 0
        before = cache.stats()
        got = run(**kwargs)
        after = cache.stats()
        assert (after["captures"] - before["captures"], after["replays"] - before["replays"]) == expected, label
        assert (edc.EDC_KERNEL.launches, stft.STFT_KERNEL.launches) == (4, 4), label
        assert sorted(got) == sorted(ref)
        for key, value in ref.items():
            np.testing.assert_array_equal(got[key], value, err_msg=f"{label} {key}")
    cache.clear()


def _interleaved_taps(taps: int, channels: int, n: int, seed: int):
    """(taps, n, channels) int16 PCM of decaying noise behind an impulse,
    as a bundle of C > 2 channels loads, and the lengths."""
    x, lengths = _graph_taps(taps, n, seed)
    wide = np.concatenate([x * (1.0 - 0.05 * k) for k in range(channels // 2)], axis=1)
    return np.ascontiguousarray((wide * 32767.0).astype(np.int16).transpose(0, 2, 1)), lengths


def _interleaved_run(x, lengths, config, dev, chunk=2):
    from audio_analysis_tpu_torch.io import ChunkLoader

    def read(lo, hi, out):
        out[...] = x[lo:hi]
    loader = ChunkLoader(read, x.shape[2], True)
    return analyze_bundle_pipelined(loader, lengths, x.shape[1], config, chunk, device=dev)


def test_interleaved_chunks_on_card_match_planar_cpu(dev):
    """3 taps of 16 interleaved PCM16 channels through the pipeline's
    staging buffers and the step's split on the card, against the same
    taps planar on the CPU: flags and counts equal, metrics as
    test_engine_on_card_matches_cpu holds them."""
    n = 1 << 16
    x, lengths = _interleaved_taps(3, 16, n, 11)
    cfg = dataclasses.replace(EngineConfig(), band_mode="third")
    got = _interleaved_run(x, lengths, cfg, dev)
    planar = np.ascontiguousarray(x.transpose(0, 2, 1))
    ref = analyze_bundle_pipelined(lambda lo, hi: planar[lo:hi], lengths, n, cfg, 2, device="cpu")
    assert sorted(got) == sorted(ref) and got["start_index"].shape == (3, 16)
    for key, value in ref.items():
        a, b = got[key], value
        assert a.dtype == b.dtype and a.shape == b.shape, key
        if key.endswith("_ok") or a.dtype == np.int32:
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            rtol = 1e-2 if key in ("modal_rt60", "modal_r2") else 1e-3
            np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-4, equal_nan=True, err_msg=key)


def test_interleaved_graph_runs_bit_equal_to_eager_and_reuse_the_staging_ring(dev, monkeypatch):
    """5 taps of 16 channels in chunks of 2 (the last chunk padded): a
    call captures the interleaved key after its first chunk and replays
    it for the other two, a second call replays all three, both bit-equal
    to the eager() run; the page-locked staging buffers are the
    same ones in every call, one ring of prefetch + 1 for the shape."""
    n = 1 << 16
    x, lengths = _interleaved_taps(5, 16, n, 12)
    with eager():
        ref = _interleaved_run(x, lengths, EngineConfig(), dev)
    cache = graphs.StepGraphs(min_calls_ahead=0)
    monkeypatch.setattr(graphs, "STEP_GRAPHS", cache)
    try:
        rings = []
        for _call in range(2):
            got = _interleaved_run(x, lengths, EngineConfig(), dev)
            rings.append([slot[0].data_ptr() for slot in batch_module._STAGING[(2, n, 16)]])
            for key, value in ref.items():
                np.testing.assert_array_equal(got[key], value, err_msg=key)
        assert cache.stats()["captures"] == 1 and cache.stats()["replays"] == 5
        assert rings[0] == rings[1] and len(rings[0]) == 3
        assert batch_module._STAGING[(2, n, 16)][0][0].is_pinned()
    finally:
        cache.clear()


@pytest.mark.parametrize("layout", ["planar", "interleaved"])
@pytest.mark.parametrize("band_mode", ["three", "third"])
def test_every_replayed_chunk_shows_the_block_markers_in_order(dev, monkeypatch, band_mode, layout):
    """6 taps in chunks of 2, the step captured on a first call: under
    torch.profiler a second call replays its 3 chunks, and the device
    trace holds each chunk's block markers (ops/marker.py), in the step's
    order, after the call's first upload and before its last fetch: 7 a
    planar chunk, and the split's marker first on an interleaved one."""
    from torch.profiler import ProfilerActivity, profile

    from audio_analysis_tpu_torch.ops import marker

    n = 1 << 16
    cache = graphs.StepGraphs(min_calls_ahead=0)
    monkeypatch.setattr(graphs, "STEP_GRAPHS", cache)
    config = dataclasses.replace(EngineConfig(), band_mode=band_mode)
    if layout == "planar":
        x, lengths = _graph_taps(6, n, 8)
        blocks = [b for b in marker.BLOCKS if b != "deinterleave"]

        def run():
            return analyze_bundle_pipelined(lambda lo, hi: x[lo:hi], lengths, n, config, 2, device=dev)
    else:
        x, lengths = _interleaved_taps(6, 4, n, 8)
        blocks = list(marker.BLOCKS)

        def run():
            return _interleaved_run(x, lengths, config, dev)

    try:
        run()
        torch.cuda.synchronize()
        before = cache.stats()["replays"]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        assert cache.stats()["replays"] - before == 3
        events = list(prof.profiler.kineto_results.events())
        marks = sorted((e.start_ns(), e.name()) for e in events
                       if e.device_type().name == "CUDA" and e.name().startswith("aa_mark_"))
        assert [name.split("(")[0] for _t, name in marks] == [f"aa_mark_{b}" for b in blocks] * 3
        kernels = sorted(e.start_ns() for e in events
                         if e.device_type().name == "CUDA" and not e.name().startswith("aa_mark_"))
        assert kernels[0] < marks[0][0] and marks[-1][0] < kernels[-1]
    finally:
        cache.clear()


def test_the_graphs_of_a_device_share_one_pool(dev):
    """Three keys captured on cuda:0: one pool handle, and every graph's
    static output lies in a segment of that pool; after clear() the next
    capture starts a new pool."""
    cache = graphs.StepGraphs(min_calls_ahead=0)
    step = batch_module._analyze_batch_flat
    try:
        for taps in (1, 2, 3):
            x, lengths = _graph_taps(taps, 1 << 16, taps)
            cache.run(step, torch.from_numpy(x).to(dev), torch.from_numpy(lengths).to(dev), EngineConfig())
        assert cache.stats()["captures"] == 3 and len(cache._pools) == 1
        (pool,) = cache._pools.values()
        segments = [(seg["address"], seg["address"] + seg["total_size"]) for seg in torch.cuda.memory_snapshot()
                    if tuple(seg.get("segment_pool_id", (0, 0))) == tuple(pool)]
        for entry in cache._entries.values():
            ptr = entry.output.data_ptr()
            assert any(lo <= ptr < hi for lo, hi in segments)
        cache.clear()
        assert cache._pools == {}
        x, lengths = _graph_taps(1, 1 << 16, 1)
        cache.run(step, torch.from_numpy(x).to(dev), torch.from_numpy(lengths).to(dev), EngineConfig())
        assert cache._pools and tuple(next(iter(cache._pools.values()))) != tuple(pool)
    finally:
        cache.clear()


def test_a_full_cufft_plan_cache_refuses_the_capture_and_the_replay(dev):
    """A capture raises when torch's cuFFT plan cache is full (a plan the
    graph captures could be evicted under it); a replay raises when the
    cache has shrunk since its capture."""
    plans = torch.backends.cuda.cufft_plan_cache[0]
    max_size = plans.max_size
    x, lengths = _graph_taps(2, 1 << 16, 8)
    xs, ls = torch.from_numpy(x).to(dev), torch.from_numpy(lengths).to(dev)
    step = batch_module._analyze_batch_flat
    cache = graphs.StepGraphs(min_calls_ahead=0)
    try:
        step(xs, ls, EngineConfig())
        plans.max_size = plans.size
        with pytest.raises(RuntimeError, match="cuFFT plan cache is full"):
            cache.run(step, xs, ls, EngineConfig())
        plans.max_size = max_size
        cache.run(step, xs, ls, EngineConfig())
        plans.clear()
        with pytest.raises(RuntimeError, match="cuFFT plan cache went from"):
            cache.run(step, xs, ls, EngineConfig())
    finally:
        plans.max_size = max_size
        cache.clear()


# step configs whose captured programs differ (tests/test_torch_fuzz_engine.py's space)
CAPTURE_CASES = {
    "three": ({}, np.int16),
    "octave": ({"band_mode": "octave"}, np.float32),
    "third": ({"band_mode": "third"}, np.int16),
    "three_decimate": ({"bands_decimate": True}, np.int16),
    "third_decimate": ({"band_mode": "third", "bands_decimate": True}, np.float32),
    "modal_trim_bins": ({"modal_trim_bins": True}, np.int16),
    "mono_n_fft_3000": ({"downmix_to_mono": True, "n_fft": 3000, "hop_length": 700}, np.float32),
    "decay_only": ({"run_bands": False, "run_fr": False, "run_group_delay": False, "run_stft": False,
                    "run_modal": False, "run_diffusion": False}, np.float32),
}


@pytest.mark.parametrize("case", sorted(CAPTURE_CASES))
def test_step_captures_after_a_warm_step_with_no_sync(dev, case):
    """A warm eager step under torch.cuda.set_sync_debug_mode("error") (a
    synchronising call or a pageable copy raises), then the capture and a
    replay of the same chunk: bit-equal to the eager step, with the
    kernels' launches of one eager step."""
    fields, dtype = CAPTURE_CASES[case]
    cfg = dataclasses.replace(EngineConfig(), **fields)
    x, lengths = _graph_taps(2, 1 << 16, 7)
    if dtype == np.int16:
        x = np.clip(np.round(x * 32767.0), -32768, 32767).astype(np.int16)
    xs, ls = torch.from_numpy(x).to(dev), torch.from_numpy(lengths).to(dev)
    step = batch_module._analyze_batch_flat
    before = (edc.EDC_KERNEL.launches, stft.STFT_KERNEL.launches)
    step(xs, ls, cfg)  # the lazy uploads
    per_step = (edc.EDC_KERNEL.launches - before[0], stft.STFT_KERNEL.launches - before[1])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ref, spec = step(xs, ls, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cache = graphs.StepGraphs(min_calls_ahead=0)
    try:
        cache.run(step, xs, ls, cfg)
        before = (edc.EDC_KERNEL.launches, stft.STFT_KERNEL.launches)
        got, got_spec = cache.run(step, xs, ls, cfg)
        assert (edc.EDC_KERNEL.launches - before[0], stft.STFT_KERNEL.launches - before[1]) == per_step
        assert cache.stats()["replays"] == 1 and got_spec == spec
        torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)
    finally:
        cache.clear()


@pytest.mark.parametrize("read", ["item", "pageable_upload"])
def test_a_capture_that_meets_a_host_read_raises(dev, read):
    """A step that reads a value back or copies from pageable host memory
    runs eagerly, then its capture raises; nothing is cached, and the card
    keeps working."""

    def step(samples, lengths, config):
        flat = samples.sum(dim=-1).reshape(-1)
        if read == "item":
            flat = flat * float(flat[0].item())
        else:
            flat = flat + torch.tensor([1.0], device=samples.device)
        return flat, []

    cache = graphs.StepGraphs(min_calls_ahead=0)
    xs = torch.ones((2, 2, 64), device=dev)
    ls = torch.full((2,), 64, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError):
        cache.run(step, xs, ls, read)
    assert cache.keys() == [] and cache.stats()["captures"] == 0
    assert float(torch.ones(8, device=dev).sum().item()) == 8.0


# K5 (csrc/dbfit.cu): the engine's three ranges on K1's curves at the
# engine's shapes, 1,155,072 samples (the 24 s tap padded): a chunk's 16
# broadband rows, a tap's 2 x 26 third-octave rows, a chunk's 8 x 2 x 3
# three-band rows, and the --bands-decimate lengths 2^14-2^18
ENGINE_RANGES = ((-5.0, -35.0), (-5.0, -25.0), (0.0, -10.0))
N_TAP = 1_155_072
DBFIT_SHAPES = {
    "broadband": ((16,), N_TAP, 48_000),
    "third_octave": ((2, 26), N_TAP, 48_000),
    "three_band": ((8, 2, 3), N_TAP, 48_000),
    "decimated_2^14": ((12,), 1 << 14, 48_000 / 64),
    "decimated_2^15": ((16,), 1 << 15, 48_000 / 32),
    "decimated_2^18": ((16,), 1 << 18, 48_000 / 4),
}


def _k1_curves(shape, n: int, seed: int, dev):
    """K1's curves of decaying noise that falls 35-140 dB over the row,
    with drawn lengths (the first row whole), on the card."""
    g = torch.Generator().manual_seed(seed)
    rows = int(np.prod(shape))
    tau = n / (8.0 + 52.0 * torch.rand(rows, 1, generator=g))
    x = torch.randn(rows, n, generator=g) * torch.exp(-torch.arange(n, dtype=torch.float32) / tau)
    lengths = torch.randint(n // 2, n + 1, (rows,), generator=g, dtype=torch.int32)
    lengths[0] = n
    x = torch.where(torch.arange(n) < lengths[:, None], x, 0.0)
    xs, ls = x.reshape(*shape, n).to(dev), lengths.reshape(shape).to(dev)
    return edc.schroeder_edc_db(xs, ls).edc_db, ls


@pytest.mark.parametrize("case", sorted(DBFIT_SHAPES))
def test_dbfit_kernel_matches_plain_at_engine_shapes(dev, case):
    shape, n, sr = DBFIT_SHAPES[case]
    curve, lengths = _k1_curves(shape, n, len(case) + n, dev)
    before = dbfit.DBFIT_KERNEL.launches
    got = dbfit.fit_decay_ranges(curve, lengths, ENGINE_RANGES, -80.0, sr)
    assert dbfit.DBFIT_KERNEL.launches == before + 1
    ref = dbfit.fit_decay_ranges_plain(curve, lengths, ENGINE_RANGES, -80.0, sr)
    rows = int(np.prod(shape))
    assert_fits_agree(got, ref, curve.reshape(rows, n).cpu().numpy(), lengths.reshape(rows).cpu().numpy(),
                      dbfit._seconds_per_sample(sr))
    assert float(ref[0].ok.float().mean()) > 0.5


def test_dbfit_kernel_edge_rows(dev):
    curve, lengths = edge_curves(4096 + 3)
    got = dbfit.fit_decay_ranges(curve.to(dev), lengths.to(dev), ENGINE_RANGES, -80.0, 48_000)
    ref = dbfit.fit_decay_ranges_plain(curve.to(dev), lengths.to(dev), ENGINE_RANGES, -80.0, 48_000)
    assert_edge_rows_cornered(ref)
    assert_fits_agree(got, ref, curve.numpy(), lengths.numpy(), dbfit._seconds_per_sample(48_000))


def test_dbfit_kernel_two_calls_bit_identical(dev):
    curve, lengths = _k1_curves((2, 26), N_TAP, 11, dev)
    first = dbfit.fit_decay_ranges_cuda(curve, lengths, ENGINE_RANGES, -80.0, 48_000)
    second = dbfit.fit_decay_ranges_cuda(curve, lengths, ENGINE_RANGES, -80.0, 48_000)
    for a, b in zip(first, second):
        for name in a._fields:
            assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("band_mode,launches", [("three", 2), ("third", 3)])
def test_dbfit_launches_on_one_engine_chunk(dev, band_mode, launches):
    """One chunk of 2 taps: K5 fits the broadband curves once, and the band
    curves once for the chunk at three bands, once a tap at third
    octaves."""
    x, lengths = _graph_taps(2, 1 << 16, 8)
    cfg = dataclasses.replace(EngineConfig(), band_mode=band_mode)
    before = dbfit.DBFIT_KERNEL.launches
    analyze_batch(torch.from_numpy(x).to(dev), torch.from_numpy(lengths).to(dev), cfg)
    assert dbfit.DBFIT_KERNEL.launches - before == launches


@pytest.mark.parametrize("route", ["three", "third_stereo", "third_16ch", "three_decimate", "third_decimate"])
def test_band_outputs_bit_equal_to_the_shifted_route_on_card(dev, route):
    """The step's band outputs with K1 reading each band row from its
    start, against `_band_fits` with the plane aligned first by slicing
    each row (tests/_band_route.py), bit for bit."""
    from _band_route import assert_bit_equal, band_outputs_both_routes

    got, ref = band_outputs_both_routes(route, 1 << 18, dev)
    assert float(got["band_t30_ok"].float().mean()) > 0.5
    assert_bit_equal(got, ref)


@pytest.mark.parametrize("route", ["three", "third_stereo", "three_decimate", "third_decimate"])
def test_k1_k5_launches_and_one_shifted_launch_per_band_plane(dev, route):
    """One chunk of 2 taps: K1 and K5 launch once for the broadband curves
    and once a band plane (the chunk's at three bands, a tap's at third
    octaves, one a decimation group), as before; each band plane's K1
    launch reads through row starts, the broadband one does not."""
    from _band_route import BAND_ROUTES, route_taps

    band_mode, channels, decimate = BAND_ROUTES[route]
    n = 1 << 18
    x, lengths = route_taps(2, channels, n, 3)
    cfg = dataclasses.replace(EngineConfig(), band_mode=band_mode, bands_decimate=decimate)
    groups = len(set(fftmask.band_decimation_factors(band_masks(cfg, n), n))) if decimate else 1
    planes = groups * (1 if band_mode == "three" else 2)
    counters = (edc.EDC_KERNEL, dbfit.DBFIT_KERNEL, edc.EDC_SHIFTED)
    before = [c.launches for c in counters]
    analyze_batch(torch.from_numpy(x).to(dev), torch.from_numpy(lengths).to(dev), cfg)
    assert [c.launches - b for c, b in zip(counters, before)] == [1 + planes, 1 + planes, planes]


@pytest.mark.parametrize("route", ["three", "third_stereo", "third_16ch"])
def test_no_gather_between_the_bands_and_fr_markers(dev, route):
    """An eager step under torch.profiler: the device kernels between the
    `aa_mark_bands` and `aa_mark_fr_gd` markers include K1 and no gather
    (the shifted plane's `_scatter_gather_elementwise_kernel`)."""
    from torch.profiler import ProfilerActivity, profile

    from _band_route import BAND_ROUTES, route_taps

    band_mode, channels, _ = BAND_ROUTES[route]
    x, lengths = route_taps(2, channels, 1 << 18, 4)
    xs, ls = torch.from_numpy(x).to(dev), torch.from_numpy(lengths).to(dev)
    cfg = dataclasses.replace(EngineConfig(), band_mode=band_mode)
    with eager():
        analyze_batch(xs, ls, cfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            analyze_batch(xs, ls, cfg)
            torch.cuda.synchronize()
    kernels = sorted((e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                     if e.device_type().name == "CUDA")
    marks = {name.split("(")[0]: t for t, name in kernels if name.startswith("aa_mark_")}
    inside = [name for t, name in kernels if marks["aa_mark_bands"] < t < marks["aa_mark_fr_gd"]]
    assert any("edc_kernel" in name for name in inside)
    assert not [name for name in inside if "gather" in name.lower()], inside
