"""GPU-only copies of the kernel comparisons: each CUDA kernel of the port
against its plain torch version on the card, the engine on the card
against the engine on the CPU, the per-file analyses on the card against
the same call on the CPU, a mesh of two shards on the card against the
single-device run (bit-equal), the AR Gram in float32 on the card against a
float64 Gram on the card, Karplus-Strong on the card against the CPU, the
report suite's render jobs with the kernels against the plain versions on
the card (and its markdown against the golden report), and the
spectrogram's display pooling on the card against the CPU.
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
percentiles within one 1/128-dB step.
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
from _summary_parity import assert_summaries_agree
from audio_analysis_tpu_torch import signals
from audio_analysis_tpu_torch.analyses import decay, filterplot, modalcloud, rt60bands, spectrogram, zplane
from audio_analysis_tpu_torch.analyses._common import FileDsp
from audio_analysis_tpu_torch.engine import (
    EngineConfig,
    analyze_batch,
    analyze_batch_sharded,
    analyze_bundle_pipelined,
    make_mesh,
)
from audio_analysis_tpu_torch.engine.batch import band_masks
from audio_analysis_tpu_torch.ops import display, edc, fftmask, spectral, stft
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
    third-octave mode)."""
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
    before = edc.EDC_KERNEL.launches
    got = analyze_batch(xs, ls, cfg)
    assert edc.EDC_KERNEL.launches - before == 1 + groups * (1 if band_mode == "three" else 2)
    with mock.patch.object(edc, "schroeder_edc_db_cuda", edc.schroeder_edc_db_plain), \
            mock.patch.object(stft, "stft_magnitude_cuda", stft.stft_magnitude_plain):
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
