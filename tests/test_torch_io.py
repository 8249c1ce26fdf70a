"""The port's own bundle I/O (audio_analysis_tpu_torch.io) against the JAX
package's (audio_analysis_tpu.io), on the CPU.

A small bundle made from a seed (stereo taps of unequal lengths and one
mono tap) is written by each package and decoded by each, through the
native C++ decoder and through the scipy path; every result must be
identical: same dtypes, np.array_equal, same files byte for byte. A
subprocess shows that importing the port loads neither the JAX package
nor jax nor matplotlib.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from audio_analysis_tpu.io import bundle as jax_bundle
from audio_analysis_tpu.io import native as jax_native
from audio_analysis_tpu.io import wav as jax_wav
from audio_analysis_tpu_torch.io import bundle as torch_bundle
from audio_analysis_tpu_torch.io import native as torch_native
from audio_analysis_tpu_torch.io import wav as torch_wav

REPO = Path(__file__).resolve().parents[1]
SR = 48_000


def _taps():
    rng = np.random.default_rng(11)
    taps = {}
    for name, n in (("a_left", 5000), ("b_long", 9001), ("c_short", 700)):
        taps[name] = (0.3 * rng.standard_normal((n, 2))).astype(np.float32)
    taps["d_mono"] = (0.5 * rng.standard_normal(3333)).astype(np.float32)
    taps["b_long"][100, 0] = 1.5  # clipped on write
    return taps


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    assert torch_native.ensure_built() == jax_native.ensure_built()
    taps = _taps()
    root = tmp_path_factory.mktemp("io")
    jax_root = jax_bundle.write_bundle(root / "jax", taps, SR)
    torch_root = torch_bundle.write_bundle(root / "torch", taps, SR)
    return jax_root, torch_root


@pytest.fixture(params=["native", "scipy"])
def decoder(request, monkeypatch):
    # empty read caches: every case decodes through the decoder it names
    monkeypatch.setattr(torch_wav, "_RAW_CACHE", {})
    monkeypatch.setattr(jax_wav, "_RAW_CACHE", {})
    if request.param == "native":
        if not torch_native.available():
            pytest.skip("the native decoder (make -C cpp) did not build")
    else:
        monkeypatch.setattr(torch_native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    return request.param


def _assert_same(a, b, where):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    elif isinstance(a, (tuple, list)) and not isinstance(a, str):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif hasattr(a, "__dataclass_fields__"):
        assert vars(a) == vars(b), where
    else:
        assert a == b, where


def test_written_bundles_are_byte_identical(bundles, decoder):
    jax_root, torch_root = bundles
    if decoder == "scipy":
        taps = _taps()
        jax_root = jax_bundle.write_bundle(jax_root.parent / "jax_scipy", taps, SR)
        torch_root = torch_bundle.write_bundle(torch_root.parent / "torch_scipy", taps, SR)
    names = sorted(p.name for p in (jax_root / "taps").iterdir())
    assert names == sorted(p.name for p in (torch_root / "taps").iterdir()) and len(names) == 4
    for name in names:
        assert (jax_root / "taps" / name).read_bytes() == (torch_root / "taps" / name).read_bytes(), name
    assert (jax_root / "meta.json").read_text() == (torch_root / "meta.json").read_text()


@pytest.mark.parametrize("side", ["jax_written", "torch_written"])
@pytest.mark.parametrize(
    "loader,kwargs",
    [
        ("read_bundle_meta", {}),
        ("load_bundle_batch", {}),
        ("load_bundle_batch", {"pad_multiple": 1000, "num_threads": 2}),
        ("load_bundle_batch_i16", {}),
        ("load_bundle_batch_i16", {"pad_multiple": 512}),
    ],
)
def test_loaders_decode_identically(bundles, decoder, side, loader, kwargs):
    root = bundles[0] if side == "jax_written" else bundles[1]
    theirs = getattr(jax_bundle, loader)(root, **kwargs)
    ours = getattr(torch_bundle, loader)(root, **kwargs)
    if loader == "load_bundle_batch_i16" and decoder == "scipy":
        assert ours is None and theirs is None
        return
    _assert_same(ours, theirs, loader)
    if loader == "load_bundle_batch":
        meta, batch, lengths, names = ours
        assert batch.dtype == np.float32 and lengths.dtype == np.int32
        assert list(lengths) == [5000, 9001, 700, 3333] and names == meta.taps
        assert np.array_equal(batch[3, 0], batch[3, 1])  # the mono tap, duplicated


@pytest.mark.parametrize("chunk", [1, 3, 4])
def test_chunked_int16_loader_decodes_identically(bundles, decoder, chunk):
    root = bundles[1]
    theirs = jax_bundle.open_bundle_chunks_i16(root, pad_multiple=2048)
    ours = torch_bundle.open_bundle_chunks_i16(root, pad_multiple=2048)
    if decoder == "scipy":
        assert ours is None and theirs is None
        return
    _assert_same(ours[:4], theirs[:4], "open_bundle_chunks_i16")
    assert ours[3] == 10240
    for lo in range(0, len(ours[2]), chunk):
        hi = min(lo + chunk, len(ours[2]))
        a, b = ours[4](lo, hi), theirs[4](lo, hi)
        assert a.dtype == np.int16 and a.shape == (hi - lo, 2, 10240)
        _assert_same(a, b, f"chunk [{lo}:{hi})")


def test_chunked_loader_refuses_a_float_tap(bundles, tmp_path):
    if not torch_native.available():
        pytest.skip("the native decoder (make -C cpp) did not build")
    from scipy.io import wavfile

    root = torch_bundle.write_bundle(tmp_path / "mixed", _taps(), SR)
    wavfile.write(str(root / "taps" / "c_short.wav"), SR, np.zeros((700, 2), np.float32))
    assert torch_bundle.open_bundle_chunks_i16(root) is None
    assert torch_bundle.load_bundle_batch_i16(root) is None
    _assert_same(torch_bundle.load_bundle_batch(root), jax_bundle.load_bundle_batch(root), "mixed")


def test_port_imports_no_jax_package():
    code = (
        "import sys\n"
        "import audio_analysis_tpu_torch\n"
        "import audio_analysis_tpu_torch.cli.analyse_cli\n"
        "import audio_analysis_tpu_torch.engine\n"
        "import audio_analysis_tpu_torch.report\n"
        "import audio_analysis_tpu_torch.io\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'matplotlib', 'audio_analysis_tpu')\n"
        "             or m.startswith(('jax.', 'matplotlib.', 'audio_analysis_tpu.')))\n"
        "assert not bad, bad\n"
        "print('CLEAN')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO / "tests"), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "CLEAN" in proc.stdout
