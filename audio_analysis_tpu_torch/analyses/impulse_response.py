"""
Impulse-response waveform views (audio_analysis_tpu/analyses/
impulse_response.py), the analysis half: the view settings, the magnitude
envelope of the log view, and the per-channel stats that the JAX package's
`plot_ir_from_wav_file` returns for `ir --json`. Host numpy only, as in the
JAX package; the three figures are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from audio_analysis_tpu_torch.io.wav import load_wav_file


@dataclass(frozen=True)
class ImpulseResponseViewSettings:
    early_window_seconds: float = 0.08
    log_magnitude_floor_db: float = -120.0
    use_mono_downmix: bool = False


def compute_log_magnitude(samples: np.ndarray) -> np.ndarray:
    """Magnitude envelope for log plotting (plain abs)."""
    return np.abs(samples).astype(np.float32)


def analyse_ir_from_wav_file(
    wav_file_path: str | Path,
    settings: Optional[ImpulseResponseViewSettings] = None,
) -> dict:
    """The deterministic per-channel stats the IR views show: the peak's
    index and magnitude, the length and duration of every channel of the
    file (the views' settings change only the figures)."""
    loaded = load_wav_file(
        wav_file_path,
        expected_channel_mode="mono_or_stereo",
        allow_mono_and_upmix_to_stereo=False,
    )
    x = loaded.samples  # (N, C)
    sr = int(loaded.sample_rate_hz)
    channels = []
    for c in range(x.shape[1]):
        mag = np.abs(x[:, c])
        peak = int(np.argmax(mag))
        channels.append(
            {
                "peak_sample_index": peak,
                "peak_abs": float(mag[peak]),
                "num_samples": int(x.shape[0]),
                "duration_seconds": float(x.shape[0] / sr),
            }
        )
    return {"sample_rate_hz": sr, "channels": channels}
