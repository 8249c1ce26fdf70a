"""
The worked example of examples/gallery/ through the PyTorch/CUDA port.

Writes the same synthetic plate-verb IR as scripts/make_example_gallery.py
(a copy of its host-numpy `make_example_verb_ir`, so the WAV is
bit-identical) into OUTPUT_DIR and runs the port's `report` on it: the
markdown and the figure set, to be set beside the committed JAX gallery.
It never writes into examples/gallery/. Drawing needs matplotlib.

Usage: python scripts/torch_make_example_gallery.py OUTPUT_DIR [--device cuda|cpu]
       (default --device cuda; --device cpu runs the plain torch versions,
       like the JAX gallery's CPU backend)
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SR = 48_000
N = 1 << 18  # 5.46 s: the longest band RT60 (2.2 s) decays within the buffer
SEED = 20260820
ONSET = 960  # 20 ms of pre-delay silence


def make_example_verb_ir() -> np.ndarray:
    """Deterministic stereo plate-verb-style IR (host numpy only): lows
    ring about 3x longer than highs, a few panned early reflections, the
    channels decorrelated."""
    rng = np.random.default_rng(SEED)
    t = np.arange(N - ONSET) / SR

    # band edges (Hz) and their RT60s
    bands = [(20.0, 400.0, 2.2), (400.0, 3000.0, 1.4), (3000.0, SR / 2, 0.8)]
    freqs = np.fft.rfftfreq(N - ONSET, d=1.0 / SR)

    tail = np.zeros((N - ONSET, 2), np.float64)
    for lo, hi, rt60 in bands:
        mask = ((freqs >= lo) & (freqs < hi)).astype(np.float64)
        env = 10.0 ** (-3.0 * t / rt60)
        for ch in range(2):
            noise = rng.standard_normal(N - ONSET)
            band = np.fft.irfft(np.fft.rfft(noise) * mask, n=N - ONSET)
            tail[:, ch] += band * env

    # early reflections: sparse taps over the first 25 ms, lightly panned
    ir = np.zeros((N, 2), np.float64)
    for delay_ms, gain, pan in ((0.0, 1.0, 0.0), (7.1, 0.62, -0.3),
                                (11.3, 0.48, 0.35), (17.9, 0.36, -0.2),
                                (24.7, 0.27, 0.25)):
        i = ONSET + int(delay_ms * 1e-3 * SR)
        ir[i, 0] += gain * (1.0 - max(0.0, pan))
        ir[i, 1] += gain * (1.0 + min(0.0, pan))

    ir[ONSET:, :] += 0.11 * tail
    ir *= 0.9 / np.max(np.abs(ir))
    return ir.astype(np.float32)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    parser.add_argument("output_dir", help="Directory for verb_ir.wav, verb_report.md and the PNGs (created).")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the report (default cuda; cpu runs the plain torch versions).")
    args = parser.parse_args(argv)
    out_dir = Path(args.output_dir).resolve()
    if out_dir == (REPO / "examples" / "gallery").resolve():
        raise SystemExit("the committed gallery is the JAX package's: write the port's elsewhere")
    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run the plain torch versions on the host")
    out_dir.mkdir(parents=True, exist_ok=True)

    from audio_analysis_tpu_torch.io.wav import write_wav_pcm16
    from audio_analysis_tpu_torch.report.report import run_report_from_wav_file

    write_wav_pcm16(out_dir / "verb_ir.wav", make_example_verb_ir(), SR)
    # relative paths, so that the markdown header records "verb_ir.wav"
    os.chdir(out_dir)
    results = run_report_from_wav_file(Path("verb_ir.wav"), Path("verb"), device=args.device)
    print(f"gallery written: {results.summary_markdown_path.resolve()}")
    pngs = sorted(p.name for p in out_dir.glob("*.png"))
    print(f"figures: {len(pngs)}: {', '.join(pngs)}")


if __name__ == "__main__":
    main()
