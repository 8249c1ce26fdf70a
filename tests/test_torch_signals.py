"""The port's signal generators (audio_analysis_tpu_torch/signals) and gen
CLI (audio_analysis_tpu_torch/cli/gen_cli.py) against the JAX package's,
on the CPU.

- The ten numpy generators give the JAX package's samples bit for bit;
  Karplus-Strong (float32, one delay-line period per torch step) is held
  within 1e-6 absolute of the JAX package's lax.scan and of a per-sample
  float32 Python loop of the recurrence.
- log_sine_sweep and the noise-fed synthetic IRs against signals/jaxgen.py:
  the IRs within 1e-6 of the peak (the same float32 ops on the same
  noise); the sweep within 8 ulp of its largest phase times the amplitude
  (float32 exp/log differ by an ulp between libraries, and the phase
  reaches 2 pi f0 c e^(T/c)).
- Both gen CLIs on `all --channel_mode stereo` and on every subcommand with
  non-default flags: the same stdout lines and WAV files byte for byte,
  except karplus_pluck within 1 PCM16 LSB. Without CUDA the port's CLI
  exits at once unless --device cpu is given.
"""

import contextlib
import io
from unittest import mock

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from audio_analysis_tpu import signals as jsig  # noqa: E402
from audio_analysis_tpu.cli import gen_cli as jax_gen  # noqa: E402
from audio_analysis_tpu.signals import jaxgen  # noqa: E402
from audio_analysis_tpu_torch import signals as tsig  # noqa: E402
from audio_analysis_tpu_torch.cli import gen_cli as torch_gen  # noqa: E402
from audio_analysis_tpu_torch.signals import torchgen  # noqa: E402

torch.set_num_threads(2)

# generator -> kwargs (non-default where the generator has knobs)
GENERATORS = {
    "generate_impulse": dict(impulse_sample_index=7, total_duration_seconds=0.1),
    "generate_click": dict(click_duration_seconds=0.003, window_type="blackman"),
    "generate_impulse_train": dict(total_duration_seconds=0.5, impulse_period_seconds=0.1, window_type="hamming"),
    "generate_noise": dict(duration_seconds=0.3, noise_type="white", random_seed=4),
    "generate_noise_pink": dict(duration_seconds=0.3, noise_type="pink", random_seed=5),
    "generate_noise_burst": dict(burst_duration_seconds=0.05, noise_type="pink", random_seed=2, window_type="rect"),
    "generate_sine": dict(frequency_hz=997.0, duration_seconds=0.2, amplitude=0.3, initial_phase_radians=0.5),
    "generate_sine_burst": dict(frequency_hz=330.0, burst_duration_seconds=0.2, amplitude=0.9),
    "generate_log_sine_sweep": dict(duration_seconds=1.0, start_frequency_hz=50.0, end_frequency_hz=15000.0,
                                    pre_silence_seconds=0.1, post_silence_seconds=0.2),
    "generate_pluck_like": dict(duration_seconds=0.2, bandlimit_frequency_hz=5000.0, random_seed=3),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_numpy_generators_are_bit_identical(name):
    fn = name.replace("_pink", "")
    ours = getattr(tsig, fn)(**GENERATORS[name])
    theirs = getattr(jsig, fn)(**GENERATORS[name])
    assert ours.sample_rate_hz == theirs.sample_rate_hz
    assert ours.samples.dtype == theirs.samples.dtype == np.float32
    assert np.array_equal(ours.samples, theirs.samples)


@pytest.mark.parametrize("freq,blend,decay", [(110.0, 0.5, 0.996), (4000.0, 0.4, 0.99), (24000.0, 1.0, 0.9)])
def test_karplus_strong_pluck_matches_jax(freq, blend, decay):
    kwargs = dict(fundamental_frequency_hz=freq, duration_seconds=0.25, feedback_decay_factor=decay,
                  lowpass_blend=blend, random_seed=6)
    ours = tsig.generate_karplus_strong_pluck(device="cpu", **kwargs).samples
    theirs = jsig.generate_karplus_strong_pluck(**kwargs).samples
    assert ours.dtype == np.float32 and ours.shape == theirs.shape == (12000,)
    assert np.abs(ours - theirs).max() <= 1e-6


def _karplus_loop(init: np.ndarray, total: int, decay: float, blend: float) -> np.ndarray:
    """The recurrence one sample at a time, in float32."""
    decay, blend = np.float32(decay), np.float32(blend)
    buf = init.copy()
    prev, idx = buf[-1], 0
    out = np.zeros(total, dtype=np.float32)
    for i in range(total):
        cur = buf[idx]
        avg = np.float32(0.5) * (prev + cur)
        buf[idx] = decay * ((np.float32(1.0) - blend) * cur + blend * avg)
        out[i] = cur
        prev = cur
        idx = (idx + 1) % init.size
    return out


# (delay length, outputs): a partial last period, fewer outputs than the
# delay line, the shortest line, one whole period
@pytest.mark.parametrize("delay_len,total", [(109, 2000), (48, 30), (2, 501), (64, 64)])
def test_karplus_strong_scan_and_batch_match_jax_and_loop(delay_len, total):
    rng = np.random.default_rng(delay_len)
    init = rng.standard_normal((3, delay_len)).astype(np.float32)
    batch = torchgen.karplus_strong_batch(torch.from_numpy(init), total, 0.99, 0.4).numpy()
    assert batch.shape == (3, total) and batch.dtype == np.float32
    np.testing.assert_allclose(batch, jaxgen.karplus_strong_batch(init, total, 0.99, 0.4), rtol=0, atol=1e-6)
    for i in range(3):
        single = torchgen.karplus_strong_scan(torch.from_numpy(init[i]), total, 0.99, 0.4).numpy()
        assert np.array_equal(single, batch[i])
        np.testing.assert_allclose(single, jaxgen.karplus_strong_scan(init[i], total, 0.99, 0.4), rtol=0, atol=1e-6)
        np.testing.assert_allclose(single, _karplus_loop(init[i], total, 0.99, 0.4), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,f0,f1,amplitude", [(48_000, 20.0, 20_000.0, 0.5), (4_800, 50.0, 15_000.0, 0.7)])
def test_log_sine_sweep_matches_jaxgen(n, f0, f1, amplitude):
    import jax.numpy as jnp

    theirs = np.asarray(jaxgen.log_sine_sweep(n, 48_000, jnp.float32(f0), jnp.float32(f1), jnp.float32(amplitude)))
    ours = torchgen.log_sine_sweep(n, 48_000, f0, f1, amplitude, device="cpu").numpy()
    assert ours.dtype == np.float32 and ours.shape == theirs.shape
    c = (n / 48_000) / np.log(f1 / f0)
    max_phase = 2.0 * np.pi * f0 * c * (np.exp((n - 1) / 48_000 / c) - 1.0)
    assert np.abs(ours - theirs).max() <= 8.0 * amplitude * np.spacing(np.float32(max_phase))


def test_synthetic_reverb_irs_from_the_same_noise_match_jaxgen():
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, (2, 2, 8192), dtype=jnp.float32))
    theirs = np.asarray(jaxgen.synthetic_reverb_ir_batch(
        key, 2, 8192, 48_000, jnp.float32(0.5), jnp.float32(0.2), onset_samples=100
    ))
    ours = torchgen.synthetic_reverb_ir_from_noise(
        torch.from_numpy(noise.copy()), 48_000, 0.5, 0.2, onset_samples=100
    ).numpy()
    assert ours.shape == theirs.shape == (2, 2, 8192) and ours.dtype == np.float32
    assert np.abs(ours - theirs).max() <= 1e-6 * np.abs(theirs).max()
    assert np.all(ours[..., :100] == 0.0) and np.all(ours[..., 100] > 0.5)
    a = torchgen.synthetic_reverb_ir_batch(torch.Generator().manual_seed(9), 2, 4096, 48_000, 0.5, 0.2)
    b = torchgen.synthetic_reverb_ir_batch(torch.Generator().manual_seed(9), 2, 4096, 48_000, 0.5, 0.2)
    assert a.shape == (2, 2, 4096) and torch.equal(a, b)


# (id, global flags, subcommand and its flags)
GEN_RUNS = [
    ("all_stereo", ["--channel_mode", "stereo"], ["all"]),
    ("impulse", [], ["impulse", "--duration", "0.5", "--impulse_sample_index", "100"]),
    ("click", ["--channel_mode", "stereo"], ["click", "--duration", "0.002", "--window_type", "blackman"]),
    ("impulse_train", [], ["impulse_train", "--duration", "1", "--period", "0.1", "--click-duration", "0.003",
                           "--window_type", "hamming"]),
    ("noise_long", [], ["noise_long", "--duration_seconds", "1", "--noise_type", "pink", "--random_seed", "3"]),
    ("noise_burst", [], ["noise_burst", "--duration", "0.05", "--random_seed", "5", "--window_type", "rect"]),
    ("sine_sustain", ["--sample_rate_hz", "44100"], ["sine_sustain", "--freq", "997", "--duration_seconds", "0.5",
                                                     "--amplitude", "0.3", "--initial_phase_radians", "0.5"]),
    ("sine_burst", [], ["sine_burst", "--freq", "330", "--duration", "0.2", "--amplitude", "0.9"]),
    ("sweep", ["--channel_mode", "stereo"], ["sweep", "--duration_seconds", "2", "--start-freq", "50",
                                             "--end-freq", "15000", "--amplitude", "0.7",
                                             "--fade_duration_seconds", "0.02", "--pre_silence_seconds", "0.1",
                                             "--post_silence_seconds", "0.2"]),
    ("pluck", [], ["pluck", "--duration_seconds", "0.3", "--bandlimit", "5000", "--decay", "0.05",
                   "--random_seed", "2"]),
    ("karplus_pluck_4k", ["--channel_mode", "stereo"], ["karplus_pluck", "--freq", "4000",
                                                        "--duration_seconds", "0.5", "--random_seed", "1"]),
    ("karplus_pluck_custom", [], ["karplus_pluck", "--freq", "220", "--duration_seconds", "0.5",
                                  "--feedback_decay_factor", "0.99", "--lowpass_blend", "0.4", "--output", "ks"]),
]


def _run(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.mark.parametrize("flags,command", [r[1:] for r in GEN_RUNS], ids=[r[0] for r in GEN_RUNS])
def test_gen_cli_matches_jax_gen_cli(tmp_path, flags, command):
    ours_dir, theirs_dir = tmp_path / "ours", tmp_path / "theirs"
    ours = _run(torch_gen.main, ["--output-dir", str(ours_dir), *flags, "--device", "cpu", *command])
    theirs = _run(jax_gen.main, ["--output-dir", str(theirs_dir), *flags, *command])
    assert ours.replace(str(ours_dir), "D") == theirs.replace(str(theirs_dir), "D")
    names = sorted(p.name for p in theirs_dir.glob("*.wav"))
    assert names and sorted(p.name for p in ours_dir.glob("*.wav")) == names
    assert len(ours.splitlines()) == len(names)
    for name in names:
        a, b = (ours_dir / name).read_bytes(), (theirs_dir / name).read_bytes()
        if not name.startswith(("karplus_pluck", "ks")):
            assert a == b, name
            continue
        # float32 Karplus-Strong in another operation order: 1 LSB at most
        assert len(a) == len(b) and a[: a.index(b"data") + 8] == b[: b.index(b"data") + 8]
        x, y = wavfile.read(ours_dir / name)[1], wavfile.read(theirs_dir / name)[1]
        assert np.abs(x.astype(np.int32) - y.astype(np.int32)).max() <= 1, name


def test_gen_cli_without_cuda_exits_unless_cpu(tmp_path):
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(SystemExit) as exc:
            torch_gen.main(["--output-dir", str(tmp_path / "x"), "impulse"])
        assert "CUDA is not available" in str(exc.value.code)
        assert not (tmp_path / "x").exists()
        out = _run(torch_gen.main, ["--output-dir", str(tmp_path / "y"), "--device", "cpu", "impulse"])
    assert out.startswith("Wrote ") and (tmp_path / "y" / "impulse.wav").is_file()
