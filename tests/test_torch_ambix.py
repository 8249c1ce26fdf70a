"""Third-order AmbiX capture bundles (16 channels a tap, ACN order, SN3D) on
the port's normal path, `bundle --no-plots`, here on the CPU.

A bundle of 3 taps x 16 channels x 2^16 samples at 48 kHz drawn by the
benchmark's seeded generator (benchmark/benchlib/capture.py, the content of
benchmark/configs/ambix3_bundle_64.json) goes through the CLI in three-band
and third-octave modes, on the interleaved route (io.bundle: each tap's
PCM16 data chunk read as it is; engine.batch: the channels split by the
step). Checked:

- every compared metric of every channel against the benchmark's float64
  reference (benchmark/reference/engine.py) within the limits of the cell
  `ambix64.third` (benchmark/limits/ambix64.third.json), family by family;
- channel independence: the 16-channel tap gives each channel the values
  that the 8 stereo taps made of its channel pairs give through the stereo
  route (stereo-only keys and the bundle's median T30 left out);
- bundle_metrics.json lists the 16 channels; the phases of the route;
- a bundle mixing channel counts, and the stereo downmix of a 16-channel
  bundle, are refused with a named error;
- a mono or stereo bundle's bundle_metrics.json is, byte for byte, the
  json.dumps of the dict the report built before its metrics were encoded
  a chunk at a time;
- the interleaved read, 16-channel comb taps read back whole through the
  loaders and their RT60s recovered, the interleaved step's split and its
  marker, and the float32 route of a 16-channel bundle.
"""

import json
import math
import shutil
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
for _p in (str(REPO / "benchmark"), str(REPO)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from benchlib import capture, spec  # noqa: E402
from reference import engine as ref_engine  # noqa: E402

from audio_analysis_tpu_torch.cli import analyse_cli  # noqa: E402
from audio_analysis_tpu_torch.engine import EngineConfig  # noqa: E402
from audio_analysis_tpu_torch.engine.batch import analyze_batch_flat, analyze_bundle_pipelined, frame_groups  # noqa: E402
from audio_analysis_tpu_torch.io import (  # noqa: E402
    load_bundle_batch,
    load_bundle_batch_i16,
    native,
    open_bundle_chunks_i16,
    write_bundle,
)
from audio_analysis_tpu_torch.io.bundle import read_interleaved_i16  # noqa: E402
from audio_analysis_tpu_torch.ops import marker  # noqa: E402
from audio_analysis_tpu_torch.report import engine_report  # noqa: E402
from audio_analysis_tpu_torch.report.engine_report import (  # noqa: E402
    EngineBundleSettings,
    _MetricsJson,
    run_bundle_report_engine,
)

SR = 48_000
TAPS, CHANNELS, N = 3, 16, 1 << 16
SEED = 3_000_000_019
CONFIG = json.loads((REPO / "benchmark/configs/ambix3_bundle_64.json").read_text())
LIMITS = json.loads((REPO / "benchmark/limits/ambix64.third.json").read_text())["limits"]
BUNDLE_ENTRY = spec.entry("bundle")
STEREO_ONLY = ("diff_median_corr0", "diff_median_iacc")

pytestmark = pytest.mark.skipif(not native.ensure_built(), reason="the PCM16 route needs the native decoder")


def _write(root: Path, samples: torch.Tensor) -> Path:
    capture.write_capture(root, samples, SR)
    return root


def _cli(root: Path, mode: str, *extra: str) -> dict:
    analyse_cli.main(["bundle", "--input", str(root), "--no-plots", "--bands", mode, "--device", "cpu", *extra])
    return json.loads((root / "reports" / "bundle_metrics.json").read_text())


@pytest.fixture(scope="module")
def drawn():
    return capture.decaying_taps(SEED, 0, TAPS, CHANNELS, N, SR, CONFIG["content"], "cpu")["samples"]


@pytest.fixture(scope="module", params=["three", "third"])
def runs(request, drawn, tmp_path_factory):
    """(mode, the 16-channel bundle's file, the stereo pairs' file, the
    bundle root) of one band mode."""
    mode = request.param
    base = tmp_path_factory.mktemp(f"ambix_{mode}")
    wide = _cli(_write(base / "ambix", drawn), mode)
    pairs = drawn.reshape(TAPS, CHANNELS // 2, 2, N).reshape(TAPS * CHANNELS // 2, 2, N)
    stereo = _cli(_write(base / "pairs", pairs), mode)
    return mode, wide, stereo, base / "ambix"


@pytest.fixture(scope="module")
def judged(runs, drawn):
    """The widest gap of each family over the taps and channels of one
    band mode's run against the float64 reference."""
    mode, wide, _stereo, _root = runs
    settings = ref_engine.Settings(sample_rate_hz=SR, band_mode=mode)
    ref = ref_engine.Reference(settings, N, "cpu", ref_engine.FLOAT64)
    metrics = {k: np.asarray(v, np.float64) for k, v in wide["metrics"].items()}
    worst = BUNDLE_ENTRY.Worst()
    for t in range(TAPS):
        r = ref.tap(drawn[t])
        prog = {k: v[t] for k, v in metrics.items()}
        worst.merge(BUNDLE_ENTRY.gaps(prog, r, r["fr_mag"], ref.n, SR, f"tap{t}"))
    return mode, worst


@pytest.mark.parametrize("family", BUNDLE_ENTRY.FAMILIES)
def test_every_channel_within_the_cells_limits(judged, family):
    mode, worst = judged
    assert worst.value[family] <= LIMITS[family], (mode, family, worst.value[family], worst.where[family])


# Channel independence. Every block but the band filterbank and the modal
# binning computes a row from that row alone in the same float32
# operations, so those keys are equal. The filterbank's FFTs run over
# (C x bands) rows at once, and the CPU FFT's batched code paths round
# differently for 416 rows than for 52 (third octaves) or 48 and 6 (three
# bands): a band's rt60 moves by float32 rounding of the band signal,
# amplified by the fit (3.0e-5 of its value at most on this draw; allowed
# 2e-4). The modal block's binning matmul over a (C, frames) batch rounds
# likewise: rt60 and r2 within 2.7e-7, two float32 ulps (allowed 2e-6).
BATCH_ROUNDED = {"band_t30_rt60": 2e-4, "band_t20_rt60": 2e-4, "band_edt_rt60": 2e-4,
                 "modal_rt60": 2e-6, "modal_r2": 2e-6, "modal_median_rt60": 2e-6, "modal_p90_rt60": 2e-6,
                 "modal_max_rt60": 2e-6}


def test_each_channel_equals_its_stereo_pair(runs):
    mode, wide, stereo, _root = runs
    assert set(wide["metrics"]) == set(stereo["metrics"]) - set(STEREO_ONLY)
    for key, value in wide["metrics"].items():
        a = np.asarray(value, np.float64)
        b = np.asarray(stereo["metrics"][key], np.float64)
        b = b.reshape((TAPS, CHANNELS) + b.shape[2:])
        assert a.shape == b.shape, key
        assert np.array_equal(np.isnan(a), np.isnan(b)), (mode, key)
        if key in BATCH_ROUNDED:
            rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-12)
            assert np.nanmax(rel) <= BATCH_ROUNDED[key], (mode, key, float(np.nanmax(rel)))
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{mode} {key}")


def test_the_file_lists_sixteen_channels_and_the_routes_phases(runs):
    mode, wide, _stereo, root = runs
    assert wide["channels"] == [f"ch{i}" for i in range(CHANNELS)]
    assert wide["taps"] == capture.tap_names(TAPS)
    for key, value in wide["metrics"].items():
        assert np.asarray(value).shape[:2] == (TAPS, CHANNELS), key
    assert not set(STEREO_ONLY) & set(wide["metrics"])
    phases = wide["phases"]
    assert {"read_s", "tail_s", "frame_groups"} <= set(phases)
    assert phases["frame_groups"] == frame_groups(TAPS, CHANNELS, N, replace(EngineConfig(), band_mode=mode))
    report = (root / "reports" / "tap00" / "tap00_report.md").read_text()
    assert "[ch15]" in report and "[left]" not in report


@pytest.mark.parametrize("counts,odd", [((2, 16), 0), ((16, 4), 1), ((1, 16), 0)],
                         ids=["stereo_and_16", "16_and_4", "mono_and_16"])
def test_a_bundle_mixing_channel_counts_is_refused(tmp_path, counts, odd):
    x = np.zeros((N // 16, max(counts)), np.float32)
    x[10] = 0.5
    root = tmp_path / "mixed"
    (root / "taps").mkdir(parents=True)
    for i, c in enumerate(counts):
        capture.write_wav(root / "taps" / f"tap{i}.wav", (x[:, :c].T * 32767).astype(np.int16), SR)
    (root / "meta.json").write_text(json.dumps({"sample_rate_hz": SR, "length_samples": N // 16,
                                                "taps": ["tap0", "tap1"]}))
    with pytest.raises(ValueError, match=rf"tap{odd}\.wav has {counts[odd]} channel"):
        run_bundle_report_engine(root, EngineBundleSettings(), "cpu")


def test_the_stereo_downmix_of_a_sixteen_channel_bundle_is_refused(tmp_path, drawn):
    root = _write(tmp_path / "ambix", drawn[:1, :, : N // 4])
    with pytest.raises(ValueError, match="16 channels"):
        run_bundle_report_engine(root, EngineBundleSettings(use_mono_downmix_for_stereo=True), "cpu")


def _taps(count: int, channels: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    taps = {}
    for i in range(count):
        x = np.zeros((n, channels), np.float32)
        x[64:] = 0.05 * rng.standard_normal((n - 64, channels)) * (10.0 ** (-3.0 * t[: n - 64, None] / 0.4))
        x[64] = 0.9
        taps[f"tap{i:02d}"] = x[:, 0] if channels == 1 else x
    return taps


@pytest.mark.parametrize("channels,taps,chunk", [(2, 2, 8), (1, 2, 8), (2, 3, 2)],
                         ids=["stereo", "mono", "stereo_three_chunks"])
def test_a_stereo_bundles_file_is_the_json_dumps_of_its_dict(tmp_path, channels, taps, chunk):
    """The file the report writes, against json.dumps(..., separators=(",",
    ":")) of the dict the report built before (its head as the file holds
    it, its metrics each array's tolist() from the same engine run): the
    same bytes."""
    root = write_bundle(tmp_path / "b", _taps(taps, channels, 1 << 14, 5), SR)
    settings = EngineBundleSettings(config=replace(EngineConfig(), band_mode="three"), chunk_taps=chunk)
    run_bundle_report_engine(root, settings, "cpu")
    raw = (root / "reports" / "bundle_metrics.json").read_text()
    head = json.loads(raw)
    meta, lengths, _names, n_max, loader = open_bundle_chunks_i16(root)
    out = analyze_bundle_pipelined(loader, lengths, n_max, settings.config, chunk, device="cpu")
    head["metrics"] = {k: np.asarray(v).tolist() for k, v in out.items()}
    assert raw == json.dumps(head, separators=(",", ":"))
    assert list(head)[-1] == "metrics" and not {"read_s", "tail_s", "frame_groups"} & set(head["phases"])


def test_the_chunked_encoder_gives_json_dumps_bytes():
    rng = np.random.default_rng(9)
    out = {
        "a_flag": rng.random((5, 3)) > 0.5,
        "b_count": rng.integers(-5, 5, (5, 3)).astype(np.int32),
        "c_rt60": rng.standard_normal((5, 3, 4)).astype(np.float32),
        "d_scalar": rng.standard_normal(5).astype(np.float32),
    }
    out["c_rt60"][1, 2, 3] = np.nan
    out["c_rt60"][4, 0, 0] = np.inf
    out["d_scalar"][2] = -np.inf
    head = {"taps": [f"t{i}" for i in range(5)], "phases": {"x_s": 0.1}, "bundle_median_t30": None}
    enc = _MetricsJson()
    for lo, hi in ((0, 2), (2, 3), (3, 5)):
        enc.add({k: v[lo:hi] for k, v in out.items()})
    want = json.dumps(dict(head, metrics={k: v.tolist() for k, v in out.items()}), separators=(",", ":"))
    assert enc.dumps(head) == want


def test_the_interleaved_read_copies_each_data_chunk_into_a_reused_buffer(tmp_path):
    rng = np.random.default_rng(2)
    frames = (5000, 8192, 3)
    taps = [rng.integers(-32768, 32767, (f, CHANNELS), dtype=np.int16) for f in frames]
    paths = []
    for i, x in enumerate(taps):
        paths.append(tmp_path / f"t{i}.wav")
        capture.write_wav(paths[-1], x.T, SR)
    out = np.full((3, 8192, CHANNELS), 77, np.int16)
    assert read_interleaved_i16(paths, 8192, CHANNELS, out) is out
    for x, got in zip(taps, out):
        np.testing.assert_array_equal(got[: x.shape[0]], x)
        assert not got[x.shape[0]:].any()
    with pytest.raises(ValueError, match="has 16 channel.s., not 4"):
        read_interleaved_i16(paths, 8192, 4)
    with pytest.raises(ValueError, match="C-contiguous"):
        read_interleaved_i16(paths, 8192, CHANNELS, out[:, ::2])
    cut = tmp_path / "cut.wav"
    cut.write_bytes(paths[1].read_bytes()[:-100])  # its header still claims 8192 frames
    with pytest.raises(IOError, match="ends inside its data chunk"):
        read_interleaved_i16([cut], 8192, CHANNELS)


# (name, feedback gain, delay samples): a feedback comb with gain g and
# delay D decays 20 log10(g) dB every D samples, RT60 = 60 D / (sr * -20
# log10(g)); the pair cpp/recorder_demo.cpp writes in stereo
COMBS = [("comb_a", 0.93, 997), ("comb_b", 0.88, 1409)]


def test_sixteen_channel_comb_taps_read_back_whole(tmp_path):
    """Two 16-channel PCM16 taps of a feedback comb's impulse response,
    channel k scaled by 1 - k/32, of different lengths: the chunked
    loader reads every channel as the file holds it, interleaved, with
    zeros past each tap; the whole-bundle loader gives the same PCM
    planar; and the report recovers each channel's comb RT60."""
    from scipy.io import wavfile

    root = tmp_path / "combs"
    frames = (1 << 17, (1 << 17) - 5000)
    gains = 1.0 - np.arange(CHANNELS) / 32.0
    for (name, g, d), n in zip(COMBS, frames):
        ir = np.zeros(n)
        ir[::d] = g ** np.arange(len(ir[::d]))
        capture.write_wav(root / "taps" / f"{name}.wav", (0.5 * 32767 * gains[:, None] * ir).astype(np.int16), SR)
    (root / "meta.json").write_text(json.dumps({"sample_rate_hz": SR, "length_samples": frames[0],
                                                "taps": [name for name, _, _ in COMBS]}))
    meta, lengths, names, n_max, loader = open_bundle_chunks_i16(root)
    assert loader.interleaved and loader.channels == CHANNELS and list(lengths) == list(frames)
    chunk = loader(0, len(names))
    assert chunk.shape == (len(names), n_max, CHANNELS) and chunk.dtype == np.int16
    for i, name in enumerate(names):
        rate, data = wavfile.read(root / "taps" / f"{name}.wav")
        assert rate == SR and data.shape == (frames[i], CHANNELS)
        np.testing.assert_array_equal(chunk[i, : frames[i]], data)
        assert not chunk[i, frames[i]:].any()
    _meta, planar, _lengths, _names = load_bundle_batch_i16(root)
    np.testing.assert_array_equal(planar, chunk.transpose(0, 2, 1))

    run_bundle_report_engine(root, EngineBundleSettings(), "cpu")
    metrics = json.loads((root / "reports" / "bundle_metrics.json").read_text())
    assert metrics["channels"] == [f"ch{k}" for k in range(CHANNELS)]
    t30 = np.asarray(metrics["metrics"]["t30_rt60"])
    assert np.asarray(metrics["metrics"]["t30_ok"]).all()
    for i, (name, g, d) in enumerate(COMBS):
        np.testing.assert_allclose(t30[i], 60.0 * d / (SR * -20.0 * math.log10(g)), rtol=0.02, err_msg=name)


def test_the_interleaved_step_splits_first_and_is_bit_equal_to_planar(monkeypatch):
    """The interleaved step on (B, N, C) int16 PCM marks the split first
    and answers bit for bit what the planar step answers on the same PCM
    laid out (B, C, N)."""
    rng = np.random.default_rng(4)
    n = 1 << 14
    pcm = (0.2 * rng.standard_normal((2, n, 4)) * 32767).astype(np.int16)
    lengths = torch.tensor([n, n - 3000], dtype=torch.int32)
    seen = []
    monkeypatch.setattr(marker, "mark", lambda block, device: seen.append(block))
    got, got_spec = analyze_batch_flat(torch.from_numpy(pcm), lengths, EngineConfig(), interleaved=True)
    assert seen[:2] == ["deinterleave", "align_decay"] and seen.count("deinterleave") == 1
    seen.clear()
    planar = torch.from_numpy(np.ascontiguousarray(pcm.transpose(0, 2, 1)))
    ref, ref_spec = analyze_batch_flat(planar, lengths, EngineConfig())
    assert "deinterleave" not in seen and got_spec == ref_spec
    torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)


def test_the_float32_route_of_a_sixteen_channel_bundle(tmp_path, drawn, monkeypatch):
    """Without the PCM16 route the bundle decodes to planar float32, all 16
    channels, and the report answers what the interleaved route answers."""
    root = _write(tmp_path / "ambix", drawn[:1, :, : N // 4])
    meta, batch, lengths, names = load_bundle_batch(root)
    assert batch.shape == (1, CHANNELS, 4096 * math.ceil(N / 4 / 4096)) and batch.dtype == np.float32
    np.testing.assert_array_equal(batch[0, :, : N // 4], drawn[0, :, : N // 4].numpy() / 32768.0)
    settings = EngineBundleSettings(config=replace(EngineConfig(), band_mode="three"))
    run_bundle_report_engine(root, settings, "cpu")
    fast = json.loads((root / "reports" / "bundle_metrics.json").read_text())
    monkeypatch.setattr(engine_report, "open_bundle_chunks_i16", lambda root: None)
    monkeypatch.setattr(engine_report, "load_bundle_batch_i16", lambda root: None)
    shutil.rmtree(root / "reports")
    run_bundle_report_engine(root, settings, "cpu")
    slow = json.loads((root / "reports" / "bundle_metrics.json").read_text())
    assert slow["channels"] == fast["channels"] and slow["metrics"] == fast["metrics"]
