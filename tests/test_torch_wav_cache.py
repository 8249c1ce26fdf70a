"""The port's WAV read cache (audio_analysis_tpu_torch/io/wav.py
`_read_wav_raw`), a copy of the JAX package's (audio_analysis_tpu/io/wav.py
`_RAW_CACHE`), on the CPU. Decodes are counted by wrapping both decoders:
the native library's `read_wav` and scipy's `wavfile.read`.

- One `report --device cpu` of a stereo 2^16 PCM16 WAV through the port's
  CLI decodes the file exactly once, as one JAX report (figures recorded)
  does; a second report of the unchanged file decodes nothing.
- A rewrite with a new mtime decodes again; loads of an unchanged file
  return the same decoded array without decoding.
- The cache holds four files: a fifth evicts the oldest entry first, and
  the port's cache holds the same keys in the same order as the JAX
  package's after the same loads.
- An unreadable file raises, is not cached, and raises again (decoding
  again).

Each case runs with the native decoder (built with `make -C cpp` on
demand) and with scipy.
"""

import contextlib
import io
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import scipy.io.wavfile  # noqa: E402
import torch  # noqa: E402

import golden_utils  # noqa: E402
from _render_jobs import RecordingPlotWorker  # noqa: E402
from audio_analysis_tpu.io import native as jax_native  # noqa: E402
from audio_analysis_tpu.io import wav as jax_wav  # noqa: E402
from audio_analysis_tpu_torch.io import native  # noqa: E402
from audio_analysis_tpu_torch.io import wav  # noqa: E402

torch.set_num_threads(2)

SR = 48_000


class Decodes:
    """Counts calls of the port's and the JAX package's decoders."""

    def __init__(self, monkeypatch):
        self.port = self.jax = 0
        for module, side in ((native, "port"), (jax_native, "jax")):
            monkeypatch.setattr(module, "read_wav", self._counted(module.read_wav, side))
        read = scipy.io.wavfile.read

        def scipy_read(*args, **kwargs):
            # both packages' scipy path; the caller's package is the one
            # whose native decoder is off or refused the file
            self.scipy += 1
            return read(*args, **kwargs)

        self.scipy = 0
        monkeypatch.setattr(scipy.io.wavfile, "read", scipy_read)

    def _counted(self, fn, side):
        def wrapped(*args, **kwargs):
            setattr(self, side, getattr(self, side) + 1)
            return fn(*args, **kwargs)

        return wrapped


@pytest.fixture(params=["native", "scipy"])
def decodes(request, monkeypatch):
    """Empty caches in both packages, the decoder of the parameter, and
    the decode counter."""
    monkeypatch.setattr(wav, "_RAW_CACHE", {})
    monkeypatch.setattr(jax_wav, "_RAW_CACHE", {})
    if request.param == "native":
        if not (native.ensure_built() and jax_native.ensure_built()):
            pytest.skip("the native decoder (make -C cpp) did not build")
    else:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    counter = Decodes(monkeypatch)
    counter.decoder = request.param
    return counter


def _write(path, value: float, n: int = 1000):
    wav.write_wav_pcm16(path, np.full((n, 2), value, np.float32), SR)
    return path


def _load(path):
    return wav.load_wav_file(path, expected_channel_mode="mono_or_stereo")


def test_one_report_decodes_its_input_once(decodes, tmp_path):
    from audio_analysis_tpu.report.report import ReportSettings as JaxReportSettings
    from audio_analysis_tpu.report.report import run_report_from_wav_file as jax_report
    from audio_analysis_tpu_torch.cli.analyse_cli import main as cli_main

    pytest.importorskip("matplotlib")
    path = tmp_path / "tap.wav"
    wav.write_wav_pcm16(path, golden_utils.make_golden_ir(), SR)
    assert wav.read_wav_header_info(path) == (1 << 16, 2, SR)

    def port_report(name):
        with contextlib.redirect_stdout(io.StringIO()):
            cli_main(["report", "--input", str(path), "--output", str(tmp_path / name / "tap"), "--device", "cpu"])

    port_report("cold")
    if decodes.decoder == "native":
        assert (decodes.port, decodes.scipy) == (1, 0)
    else:
        assert (decodes.port, decodes.scipy) == (0, 1)
    port_report("warm")  # the unchanged file: no decode
    assert decodes.port + decodes.scipy == 1
    assert (tmp_path / "warm" / "tap_report.md").is_file()

    before = decodes.scipy
    jax_report(path, tmp_path / "jax" / "tap", JaxReportSettings(), plot_worker=RecordingPlotWorker())
    assert decodes.jax + decodes.scipy - before == 1  # the JAX report decodes it once too


def test_a_rewrite_with_a_new_mtime_decodes_again(decodes, tmp_path):
    path = _write(tmp_path / "a.wav", 0.5)
    first = _load(path)
    raw = wav._read_wav_raw(path)[1]
    assert decodes.port + decodes.scipy == 1
    assert wav._read_wav_raw(path)[1] is raw  # the cached array itself
    _write(path, -0.5)
    stat = path.stat()
    os.utime(path, ns=(stat.st_atime_ns, stat.st_mtime_ns + 1_000_000))
    second = _load(path)
    assert decodes.port + decodes.scipy == 2
    assert second.samples[0, 0] < 0.0 < first.samples[0, 0]
    assert first.samples[0, 0] == np.float32(16383 / 32768)  # not changed by the rewrite
    assert len(wav._RAW_CACHE) == 2


def test_a_fifth_file_evicts_the_oldest(decodes, tmp_path):
    paths = [_write(tmp_path / f"f{i}.wav", 0.1 * (i + 1)) for i in range(5)]

    def load_both(i):
        ours = _load(paths[i])
        theirs = jax_wav.load_wav_file(paths[i], expected_channel_mode="mono_or_stereo")
        assert np.array_equal(ours.samples, theirs.samples)

    def port_decodes():
        return decodes.port + (decodes.scipy // 2 if decodes.decoder == "scipy" else 0)

    for i in range(4):
        load_both(i)
    assert port_decodes() == 4 and wav._RAW_CACHE_MAX == 4
    load_both(0)  # a hit does not move the entry
    assert port_decodes() == 4
    load_both(4)  # evicts f0, the oldest
    assert port_decodes() == 5
    assert [k[0] for k in wav._RAW_CACHE] == [str(p) for p in paths[1:]]
    load_both(0)  # decoded again, evicting f1
    load_both(2)
    assert port_decodes() == 6
    assert [k[0] for k in wav._RAW_CACHE] == [str(paths[i]) for i in (2, 3, 4, 0)]
    assert list(wav._RAW_CACHE) == list(jax_wav._RAW_CACHE)


def test_an_unreadable_file_is_not_cached(decodes, tmp_path):
    path = tmp_path / "bad.wav"
    path.write_bytes(b"RIFF\x24\x00\x00\x00WAVEdata\x00\x00\x00\x00" + bytes(64))
    for attempt in (1, 2):
        with pytest.raises((IOError, ValueError)):
            _load(path)
        assert decodes.scipy == attempt  # every attempt reaches the decoder
        assert not any(key[0] == str(path) for key in wav._RAW_CACHE)
    with pytest.raises((IOError, ValueError)):
        jax_wav.load_wav_file(path, expected_channel_mode="mono_or_stereo")
    _write(path, 0.25)  # the repaired file loads
    assert _load(path).samples.shape == (1000, 2)
