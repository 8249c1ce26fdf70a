"""scripts/torch_make_example_gallery.py: the worked example of
examples/gallery/ through the port.

- Its copy of `make_example_verb_ir` is bit-identical to the JAX script's.
- The port's `verb_report.md` (`--device cpu`) matches the committed
  examples/gallery/verb_report.md section by section within the
  per-module tolerances of tests/test_reference_parity.py, compared by
  tests/_summary_parity.py; the header and the image lines exactly. Its
  PNG names are the committed set. This needs matplotlib.
- The script refuses to write into examples/gallery/, and without a card
  it exits unless told `--device cpu`.
"""

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _summary_parity import assert_summaries_agree
from test_reference_parity import TOLERANCES

REPO = Path(__file__).resolve().parents[1]
GALLERY = REPO / "examples" / "gallery"
SCRIPT = REPO / "scripts" / "torch_make_example_gallery.py"

# the report's sections and the per-file module each one summarises
SECTION_MODULE = {
    "Decay / EDC": "decay",
    "RT60 by band": "rt60bands",
    "Frequency response": "frequency_response",
    "Group delay": "group_delay",
    "Spectrogram": "spectrogram",
    "Waterfall": "waterfall",
    "Diffusion / echo density proxy": "diffusion",
    "Modal cloud": "modalcloud",
}


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _sections(md: str) -> dict:
    """{section title, or "" for the header: its text}."""
    parts = re.split(r"^## (.+)$", md, flags=re.M)
    return {"": parts[0], **{parts[i].strip(): parts[i + 1] for i in range(1, len(parts), 2)}}


def test_verb_ir_is_bit_identical_to_the_jax_scripts():
    ours = _load(SCRIPT, "torch_gallery_script").make_example_verb_ir()
    theirs = _load(REPO / "scripts" / "make_example_gallery.py", "jax_gallery_script").make_example_verb_ir()
    assert ours.dtype == theirs.dtype == np.float32 and ours.shape == theirs.shape
    assert ours.tobytes() == theirs.tobytes()


def test_refuses_the_committed_gallery():
    run = subprocess.run([sys.executable, str(SCRIPT), str(GALLERY)], capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and "committed gallery" in run.stderr


def test_runs_on_the_card_unless_told_otherwise(tmp_path):
    """The default device is cuda: with no card visible the script exits at
    once, naming --device cpu, and writes nothing."""
    out_dir = tmp_path / "gallery"
    run = subprocess.run(
        [sys.executable, str(SCRIPT), str(out_dir)],
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True, timeout=120,
    )
    assert run.returncode != 0 and "--device cpu" in run.stderr
    assert not out_dir.exists()


def test_port_gallery_matches_the_committed_one(tmp_path):
    pytest.importorskip("matplotlib")
    run = subprocess.run(
        [sys.executable, str(SCRIPT), str(tmp_path), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert run.returncode == 0, run.stderr[-3000:]
    ours = _sections((tmp_path / "verb_report.md").read_text())
    theirs = _sections((GALLERY / "verb_report.md").read_text())
    assert list(ours) == list(theirs)
    for title, text in theirs.items():
        rel, abs_ = TOLERANCES[SECTION_MODULE[title]] if title in SECTION_MODULE else (0.0, 0.0)
        assert_summaries_agree(text, ours[title], rel, abs_, title or "header")
    assert sorted(p.name for p in tmp_path.glob("*.png")) == sorted(p.name for p in GALLERY.glob("*.png"))
