"""Settings-space fuzz of the port's fused engine against the JAX package's,
on the CPU (hypothesis).

Each example draws an EngineConfig over every field the port has (the
JAX config's fields but its four TPU-only kernel switches, which
`config_from_jax` drops; the JAX side runs at its defaults, the Pallas
EDC switch on and the matmul STFT, as tests/test_torch_engine.py runs it)
and 1-3 stereo taps of N = 2^14 or 2^15 samples with ragged lengths: the
modal and damped IRs of tests/parity_matrix.py and a decaying-noise tap
from a drawn seed. The port's `analyze_batch` (plain torch versions on the
CPU) and the JAX package's `analyze_batch` (CPU backend) must agree under
tests/test_torch_engine.py's tolerances, as tests/_engine_parity.py applies
them to drawn settings:

- the same keys, shapes and dtypes; start_index, segment_length, peak_abs
  and the frame counts exact;
- broadband decay metrics 1e-5 relative; band RT60s 1e-4 relative;
  fr_peak_hz 1e-6, fr_centroid_hz 1e-4 relative; stft_global_max_db 1e-4
  dB; diffusion medians 1e-4 absolute; group delay 1e-3 relative on the
  decaying-noise taps only (on tonal taps the float32 phase at spectral
  nulls is noise in both packages);
- each plus 4 times the port's own spread over its conditioning runs
  (float32 round-off noise on the taps, the fits' dB targets moved by
  0.1 dB); a flag may differ only where those runs flip it; fit values
  where the fit is valid in both packages;
- per-bin modal fits 1e-2 relative, with at most max(2, 5%) of a row's
  reliable bins reliable in one package only or further apart (bins at
  float32 noise level), and the aggregates consistent with each package's
  own bins (tests/_engine_parity.py says why each rule is needed).

The mesh (engine/mesh.py) on the virtual CPU mesh (`make_mesh(n,
platform="cpu")`: n shards run one after another): a drawn EngineConfig, a
drawn shard count (1-4) and 1-5 drawn taps, fewer taps than shards among
them. `analyze_batch_sharded` and `analyze_bundle_pipelined(mesh=...)` (a
drawn chunk of taps a shard) against the port's single-device engine at
1e-6, as tests/test_torch_mesh.py holds it, with the taps in the same
batches as on the shards: on the CPU a tap's float32 result can depend on
its batch's size (a tonal tap's group-delay 90th percentile moved by
5.8e-5 relative between a batch of 1 and one of 2, where the float32
phase at spectral nulls settles nothing; ROADMAP "Known"). For two
draws also the sharded run against the JAX package's
`analyze_batch_sharded` on as many of its virtual CPU devices, under the
rules above (the per-tap outputs; the bundle aggregates are
tests/test_torch_mesh.py's).

Hypothesis runs derandomized (`derandomize=True`, no example database), so
every run draws the same examples and counts the same; the known edges are
`@example`s.
"""

import dataclasses

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from hypothesis import HealthCheck, Phase, example, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from audio_analysis_tpu.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from audio_analysis_tpu.engine import analyze_batch as jax_analyze_batch  # noqa: E402
from audio_analysis_tpu.engine.mesh import analyze_batch_sharded as jax_sharded  # noqa: E402
from audio_analysis_tpu.engine.mesh import make_mesh as jax_make_mesh  # noqa: E402
from audio_analysis_tpu_torch.engine import (  # noqa: E402
    EngineConfig,
    analyze_batch,
    analyze_batch_sharded,
    analyze_bundle_pipelined,
    config_from_jax,
    make_mesh,
)
from audio_analysis_tpu_torch.engine.config import TPU_ONLY_FIELDS  # noqa: E402
from _engine_parity import assert_engines_agree as assert_engine_runs_agree  # noqa: E402
from _engine_parity import conditioning_runs  # noqa: E402
from parity_matrix import make_damped_ir, make_modal_ir  # noqa: E402

torch.set_num_threads(2)

FUZZ = settings(
    derandomize=True, database=None, deadline=None, max_examples=10,
    suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large],
)

RTOL = {"fr_peak_hz": 1e-6, "fr_centroid_hz": 1e-4}
ATOL = {"stft_global_max_db": 1e-4}
NOISE = "noise"


def _tolerance(key):
    if key.startswith("gd_"):
        return 1e-3, 0.0
    if key in RTOL:
        return RTOL[key], 0.0
    if key in ATOL:
        return 0.0, ATOL[key]
    if key.startswith("band_"):
        return 1e-4, 0.0
    if key.startswith("diff_"):
        return 0.0, 1e-4
    return 1e-5, 1e-6


def _db_range(high_lo, high_hi, span_lo, span_hi):
    return st.tuples(
        st.floats(high_lo, high_hi), st.floats(span_lo, span_hi)
    ).map(lambda hs: (round(hs[0], 2), round(hs[0] - hs[1], 2)))


def _n_fft(largest):
    """A power of two from 256 (K2's range) or any size outside it."""
    return st.one_of(
        st.sampled_from([n for n in (256, 512, 1024, 2048, 4096, 8192, 16384) if n <= largest]),
        st.integers(64, largest).filter(lambda n: n & (n - 1)),
        st.sampled_from([64, 128]),
    )


@st.composite
def engine_configs(draw, largest=1 << 14):
    n_fft = draw(_n_fft(largest))
    divides = draw(st.booleans())
    hop = n_fft // draw(st.sampled_from([1, 2, 4, 8])) if divides else draw(st.integers(16, n_fft))
    return {
        "sample_rate_hz": draw(st.sampled_from([48_000, 44_100])),
        "trim_to_peak": draw(st.booleans()),
        "ignore_leading_seconds": draw(st.sampled_from([0.0, 0.001, 0.01, 0.02])),
        "edc_floor_db": draw(st.sampled_from([-150.0, -120.0, -90.0, -70.0])),
        "edc_epsilon": draw(st.sampled_from([1e-30, 1e-20, 1e-12])),
        "fit_lower_limit_db": draw(st.sampled_from([-95.0, -80.0, -60.0, -50.0])),
        "t20_range_db": draw(_db_range(-10.0, 0.0, 10.0, 30.0)),
        "t30_range_db": draw(_db_range(-10.0, -2.0, 20.0, 40.0)),
        "edt_range_db": draw(_db_range(-2.0, 0.0, 5.0, 15.0)),
        "band_mode": draw(st.sampled_from(["three", "octave", "third"])),
        "low_upper_hz": draw(st.sampled_from([150.0, 250.0, 400.0])),
        "mid_center_hz": draw(st.sampled_from([700.0, 1000.0, 1500.0])),
        "mid_width_octaves": draw(st.sampled_from([1.0, 2.0, 3.0])),
        "high_lower_hz": draw(st.sampled_from([2500.0, 4000.0, 6000.0])),
        "band_f_min_hz": draw(st.sampled_from([31.5, 63.0, 125.0])),
        "band_f_max_hz": draw(st.sampled_from([4000.0, 8000.0, 16000.0])),
        "transition_width_octaves": draw(st.sampled_from([1 / 12, 1 / 6, 0.5, 1.0])),
        "bands_decimate": draw(st.booleans()),
        "f_min_hz": draw(st.sampled_from([10.0, 20.0, 100.0])),
        "f_max_hz": draw(st.sampled_from([8000.0, 20000.0, 30000.0])),
        "magnitude_floor_db": draw(st.sampled_from([-140.0, -120.0, -100.0])),
        "n_fft": n_fft,
        "hop_length": hop,
        "modal_n_fft": draw(_n_fft(largest)),
        "modal_log_bins_per_octave": draw(st.sampled_from([6, 12, 24, 48])),
        "modal_min_bins": draw(st.sampled_from([4, 24, 64])),
        "modal_min_fit_points": draw(st.sampled_from([4, 10, 16])),
        "modal_min_peak_db_above_floor": draw(st.sampled_from([0.0, 20.0, 40.0])),
        "modal_trim_bins": draw(st.booleans()),
        "diffusion_window_seconds": draw(st.sampled_from([0.01, 0.02, 0.05])),
        "diffusion_hop_seconds": draw(st.sampled_from([0.005, 0.013, 0.05])),
        "diffusion_max_lag_ms": draw(st.sampled_from([0.5, 1.5, 5.0])),
        "echo_density_threshold_rms": draw(st.sampled_from([0.5, 1.0, 2.0])),
        "downmix_to_mono": draw(st.booleans()),
        **{f"run_{block}": draw(st.booleans())
           for block in ("bands", "fr", "group_delay", "stft", "modal", "diffusion")},
    }


@st.composite
def tap_sets(draw):
    n = draw(st.sampled_from([1 << 14, 1 << 15]))
    kinds = draw(st.lists(st.sampled_from(["modal", "damped", NOISE]), min_size=1, max_size=3))
    lengths = [draw(st.one_of(st.just(n), st.integers(1, n))) for _ in kinds]
    return n, kinds, lengths, draw(st.integers(0, 2**31 - 1))


def _taps(n, kinds, lengths, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((len(kinds), 2, n), np.float32)
    for i, kind in enumerate(kinds):
        if kind == NOISE:
            t = np.arange(n - 256) / 48_000
            rt60 = rng.uniform(0.2, 1.5)
            x[i, :, 256:] = 0.05 * rng.standard_normal((2, n - 256)) * 10.0 ** (-3.0 * t / rt60)
            x[i, :, 256] = 0.9
        else:
            ir = make_modal_ir() if kind == "modal" else make_damped_ir()
            take = min(n, ir.shape[0])
            x[i, :, :take] = ir[:take].T
        x[i, :, lengths[i]:] = 0.0
    return x, np.asarray(lengths, np.int32)


def _port(x, lens, cfg):
    return {k: v.numpy() for k, v in analyze_batch(torch.from_numpy(x), torch.from_numpy(lens), cfg).items()}


def run_both(fields, n, kinds, lengths, seed):
    """(JAX outputs, port outputs, the port's conditioning runs)."""
    x, lens = _taps(n, kinds, lengths, seed)
    jc = dataclasses.replace(JaxEngineConfig(), **fields)
    ref = {k: np.asarray(v) for k, v in jax_analyze_batch(jnp.asarray(x), jnp.asarray(lens), jc).items()}
    jax.clear_caches()  # one compiled engine per drawn config: keep the worker's memory flat
    cfg = config_from_jax(jc)
    return ref, _port(x, lens, cfg), conditioning_runs(_port, x, lens, cfg)


def assert_engines_agree(ref, got, runs, kinds):
    assert_engine_runs_agree(ref, got, runs, _tolerance, [k == NOISE for k in kinds])


DEFAULTS = {f.name: getattr(EngineConfig(), f.name) for f in dataclasses.fields(EngineConfig)}


# Fuzz finding (repaired): a fit's time axis. XLA computes the JAX
# package's index / sample_rate as index x (1/sample_rate) in float32; the
# port divided. At t = 0.66 s a 9-point band EDT fit moved by 1.2e-4
# relative. The draw:
TIME_AXIS_DRAW = {
    **DEFAULTS, "trim_to_peak": False, "ignore_leading_seconds": 0.02, "edc_epsilon": 1e-12,
    "t20_range_db": (-1.9, -22.75), "t30_range_db": (-2.6, -41.64), "edt_range_db": (-1.9, -6.9),
    "band_mode": "third", "low_upper_hz": 150.0, "mid_center_hz": 700.0, "mid_width_octaves": 3.0,
    "band_f_min_hz": 125.0, "band_f_max_hz": 8000.0, "transition_width_octaves": 0.5, "f_min_hz": 100.0,
    "f_max_hz": 8000.0, "n_fft": 2048, "hop_length": 57, "modal_n_fft": 2048, "modal_min_bins": 64,
    "modal_min_peak_db_above_floor": 40.0, "diffusion_window_seconds": 0.02, "diffusion_hop_seconds": 0.013,
    "diffusion_max_lag_ms": 0.5, "echo_density_threshold_rms": 2.0, "run_group_delay": False,
    "run_stft": False, "run_modal": False,
}


@settings(derandomize=True, database=None, max_examples=5)
@given(fields=engine_configs())
def test_the_draw_covers_every_field_of_the_port(fields):
    """Every field of the port's EngineConfig is drawn, and nothing else."""
    assert sorted(fields) == sorted(DEFAULTS)
    assert not set(fields) & set(TPU_ONLY_FIELDS)


@FUZZ
@given(fields=engine_configs(), taps=tap_sets())
# 0 STFT frames: every tap shorter than n_fft, one of length 1
@example(fields={**DEFAULTS, "n_fft": 8192, "hop_length": 1000}, taps=(1 << 14, ["modal", NOISE], [1, 5000], 3))
# n_fft and modal_n_fft outside K2's range: not a power of two, below 256,
# above 16384 (one frame of the whole signal)
@example(fields={**DEFAULTS, "n_fft": 3000, "hop_length": 1001, "modal_n_fft": 128, "band_mode": "octave"},
         taps=(1 << 15, ["damped", NOISE], [1 << 15, 20000], 4))
@example(fields={**DEFAULTS, "n_fft": 200, "hop_length": 64, "modal_n_fft": 5000, "downmix_to_mono": True},
         taps=(1 << 14, [NOISE], [1 << 14], 5))
@example(fields={**DEFAULTS, "n_fft": 1 << 15, "hop_length": 4096, "modal_n_fft": 20000},
         taps=(1 << 15, ["modal", NOISE], [1 << 15, 1 << 15], 6))
@example(fields=TIME_AXIS_DRAW, taps=(1 << 15, ["damped", "damped"], [1 << 15, 1 << 15], 0))
def test_engine_matches_jax(fields, taps):
    n, kinds, lengths, seed = taps
    ref, got, runs = run_both(fields, n, kinds, lengths, seed)
    assert_engines_agree(ref, got, runs, kinds)


@pytest.mark.parametrize("block", ["n_fft", "modal_n_fft"])
def test_a_frame_longer_than_the_signal_raises_as_in_jax(block):
    """Fuzz finding: n_fft or modal_n_fft above N. The JAX engine raises a
    ValueError; the port raised torch's FFT error on the CPU (and would have
    reduced over no frames on the card). Both now raise a ValueError, and
    with the block off both run."""
    x, lens = _taps(1 << 14, ["modal"], [1 << 14], 0)
    fields = {**DEFAULTS, block: 1 << 15}
    jc = dataclasses.replace(JaxEngineConfig(), **fields)
    with pytest.raises(ValueError):
        jax_analyze_batch(jnp.asarray(x), jnp.asarray(lens), jc)
    with pytest.raises(ValueError, match=block):
        _port(x, lens, config_from_jax(jc))
    off = {**fields, "run_stft" if block == "n_fft" else "run_modal": False}
    ref, got, runs = run_both(off, 1 << 14, ["modal"], [1 << 14], 0)
    assert_engines_agree(ref, got, runs, ["modal"])


def test_frame_blocks_split_by_taps_past_the_budget(monkeypatch):
    """Fuzz finding (repaired): the shared STFT and the modal cloud ran a
    chunk's taps in one plane, where the JAX engine maps them per tap; on
    the card n_fft 200, hop 25, modal_n_fft 12000 over 8 taps of 2^20 asked
    for 29.7 GiB. Past FRAME_PLANE_BUDGET_BYTES a block now runs by tap
    groups. With the budget cut below one tap, each tap is its own group
    and the outputs equal the one-group run's."""
    from audio_analysis_tpu_torch.engine import batch

    x, lens = _taps(1 << 14, ["modal", NOISE, "damped"], [1 << 14, 9000, 12000], 7)
    cfg = EngineConfig()
    assert batch.frame_tap_groups(3, 2, 1 << 14, cfg.modal_n_fft, cfg.hop_length) == [(0, 3)]
    one = _port(x, lens, cfg)
    monkeypatch.setattr(batch, "FRAME_PLANE_BUDGET_BYTES", 1)
    assert batch.frame_tap_groups(3, 2, 1 << 14, cfg.modal_n_fft, cfg.hop_length) == [(0, 1), (1, 2), (2, 3)]
    split = _port(x, lens, cfg)
    assert sorted(split) == sorted(one)
    for key in one:
        np.testing.assert_allclose(split[key], one[key], rtol=1e-6, atol=0, equal_nan=True, err_msg=key)


# ------------------------------------------------------------------ mesh ----

MESH = settings(FUZZ, max_examples=10)


@st.composite
def mesh_draws(draw):
    """(shards, N, tap kinds, lengths, seed, chunk taps a shard)."""
    shards = draw(st.integers(1, 4))
    n = draw(st.sampled_from([1 << 14, 1 << 15]))
    kinds = draw(st.lists(st.sampled_from(["modal", "damped", NOISE]), min_size=1, max_size=5))
    lengths = [draw(st.one_of(st.just(n), st.integers(1, n))) for _ in kinds]
    return shards, n, kinds, lengths, draw(st.integers(0, 2**31 - 1)), draw(st.integers(1, 3))


def _as_numpy(res: dict) -> dict:
    return {k: v.numpy() if torch.is_tensor(v) else np.asarray(v) for k, v in res.items()}


def _blockwise(x, lens, cfg, block: int) -> dict:
    """The single-device engine over consecutive blocks of `block` taps
    (the last one padded by repeating tap 0, as the mesh pads), joined and
    trimmed to the taps."""
    b = x.shape[0]
    pad = (-b) % block
    xp = np.concatenate([x, np.repeat(x[:1], pad, axis=0)])
    lp = np.concatenate([lens, np.repeat(lens[:1], pad)])
    runs = [_port(xp[i:i + block], lp[i:i + block], cfg) for i in range(0, b + pad, block)]
    return {k: np.concatenate([r[k] for r in runs])[:b] for k in runs[0]}


@MESH
@given(fields=engine_configs(), draw=mesh_draws())
@example(fields=DEFAULTS, draw=(4, 1 << 14, ["modal", NOISE], [1 << 14, 9000], 1, 2))  # fewer taps than shards
@example(fields={**DEFAULTS, "band_mode": "octave", "bands_decimate": True}, draw=(3, 1 << 14, [NOISE] * 5,
                                                                                    [1 << 14] * 5, 2, 1))
def test_mesh_matches_single_device(fields, draw):
    shards, n, kinds, lengths, seed, chunk = draw
    x, lens = _taps(n, kinds, lengths, seed)
    cfg = EngineConfig(**fields)
    mesh = make_mesh(shards, platform="cpu")
    per_shard = max(1, min(chunk, -(-len(kinds) // shards)))
    pairs = [
        (_as_numpy(analyze_batch_sharded(mesh, x, lens, cfg, include_bundle_aggregates=False)),
         _blockwise(x, lens, cfg, -(-len(kinds) // shards))),
        (_as_numpy(analyze_bundle_pipelined(lambda lo, hi: x[lo:hi], lens, n, cfg, chunk, mesh=mesh)),
         _as_numpy(analyze_bundle_pipelined(lambda lo, hi: x[lo:hi], lens, n, cfg, per_shard, device="cpu"))),
    ]
    for res, one in pairs:
        assert sorted(res) == sorted(one)
        for key, value in one.items():
            assert res[key].dtype == value.dtype and res[key].shape == value.shape, key
            np.testing.assert_allclose(res[key], value, rtol=1e-6, atol=1e-6, equal_nan=True, err_msg=key)


@settings(MESH, max_examples=1, phases=[Phase.explicit, Phase.generate])
@given(fields=engine_configs(), draw=mesh_draws())
@example(fields={**DEFAULTS, "band_mode": "three", "modal_n_fft": 4096},
         draw=(2, 1 << 14, [NOISE, "modal", NOISE], [1 << 14, 1 << 14, 12000], 3, 1))
def test_mesh_matches_the_jax_mesh(fields, draw):
    shards, n, kinds, lengths, seed, _chunk = draw
    x, lens = _taps(n, kinds, lengths, seed)
    jc = dataclasses.replace(JaxEngineConfig(), **fields)
    ref = {k: np.asarray(v) for k, v in jax_sharded(jax_make_mesh(shards, platform="cpu"), x, lens, jc).items()}
    jax.clear_caches()
    cfg = config_from_jax(jc)
    got = _as_numpy(analyze_batch_sharded(make_mesh(shards, platform="cpu"), x, lens, cfg,
                                          include_bundle_aggregates=False))
    ref = {k: v for k, v in ref.items() if k in got}
    assert_engines_agree(ref, got, conditioning_runs(_port, x, lens, cfg), kinds)
