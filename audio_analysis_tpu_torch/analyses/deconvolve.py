"""
Sweep deconvolution: an impulse response from a recorded sweep
(audio_analysis_tpu/analyses/deconvolve.py): H = Y conj(X) / (|X|^2 + eps),
eps = regularization_relative * max|X|^2, FFT length next_pow2(max(len
recorded, len sweep)), each recorded channel against the mono-downmixed
sweep, output length "recorded" | "full_fft", optional DC removal and
peak normalisation, written as a float32 WAV (default
`<recorded_stem>_ir.wav`).

The transforms are torch.fft on the given device.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from audio_analysis_tpu_torch.io.wav import (
    convert_wav_samples_to_float32,
    ensure_2d_channel_array,
    load_wav_file,
    write_wav_float32,
)
from audio_analysis_tpu_torch.ops import spectral
from audio_analysis_tpu_torch.ops.common import next_pow2


@dataclass(frozen=True)
class DeconvolveSettings:
    regularization_relative: float = 1e-10
    normalise_peak: bool = True
    target_peak: float = 0.95
    remove_dc: bool = True
    output_length_mode: str = "recorded"  # "recorded" | "full_fft"


@dataclass(frozen=True)
class DeconvolvedImpulseResponse:
    samples: np.ndarray  # (N, C) float32
    sample_rate_hz: int
    recorded_file_path: Path
    sweep_file_path: Path


def deconvolve_impulse_response(
    recorded_samples_2d: np.ndarray,
    sweep_samples_1d: np.ndarray,
    sample_rate_hz: int,
    settings: DeconvolveSettings,
    device: "str | torch.device" = "cuda",
) -> np.ndarray:
    """IR per recorded channel against one mono sweep; returns (N_out, C)."""
    recorded = ensure_2d_channel_array(convert_wav_samples_to_float32(recorded_samples_2d))
    sweep = np.asarray(sweep_samples_1d, dtype=np.float32)
    if recorded.shape[0] < 8 or sweep.size < 8:
        raise ValueError("Recorded and sweep must both contain at least a few samples.")
    if settings.output_length_mode not in ("recorded", "full_fft"):
        raise ValueError(f"Unknown output_length_mode: {settings.output_length_mode}")

    n_recorded = int(recorded.shape[0])
    n_fft = next_pow2(max(n_recorded, sweep.size))
    ir = spectral.deconvolve_spectral(
        torch.from_numpy(np.ascontiguousarray(recorded.T)).to(device),
        torch.from_numpy(sweep).to(device),
        n_fft,
        float(settings.regularization_relative),
    ).cpu().numpy().T  # (n_fft, C)

    if settings.output_length_mode == "recorded":
        ir = ir[:n_recorded]
    if settings.remove_dc and ir.size:
        ir = ir - ir.mean(axis=0, keepdims=True)
    if settings.normalise_peak and ir.size:
        peak = float(np.max(np.abs(ir)))
        if peak > 0.0:
            ir = ir * (float(settings.target_peak) / peak)
    return ir.astype(np.float32)


def deconvolve_from_wav_files(
    recorded_wav_file_path: str | Path,
    sweep_wav_file_path: str | Path,
    settings: Optional[DeconvolveSettings] = None,
    output_ir_wav_file_path: Optional[str | Path] = None,
    device: "str | torch.device" = "cuda",
) -> DeconvolvedImpulseResponse:
    if settings is None:
        settings = DeconvolveSettings()
    recorded = load_wav_file(
        recorded_wav_file_path, expected_channel_mode="mono_or_stereo", allow_mono_and_upmix_to_stereo=False
    )
    sweep = load_wav_file(
        sweep_wav_file_path, expected_channel_mode="mono_or_stereo", allow_mono_and_upmix_to_stereo=False
    )
    if recorded.sample_rate_hz != sweep.sample_rate_hz:
        raise ValueError(
            f"Sample rate mismatch: recorded={recorded.sample_rate_hz} Hz, "
            f"sweep={sweep.sample_rate_hz} Hz"
        )
    sweep_mono = np.mean(sweep.samples.astype(np.float64), axis=1).astype(np.float32)
    ir = DeconvolvedImpulseResponse(
        samples=deconvolve_impulse_response(
            recorded.samples, sweep_mono, recorded.sample_rate_hz, settings, device
        ),
        sample_rate_hz=int(recorded.sample_rate_hz),
        recorded_file_path=Path(recorded.file_path),
        sweep_file_path=Path(sweep.file_path),
    )
    if output_ir_wav_file_path is not None:
        write_wav_float32(Path(output_ir_wav_file_path), ir.samples, ir.sample_rate_hz)
    return ir


def default_output_ir_path(recorded_wav_file_path: str | Path) -> Path:
    p = Path(recorded_wav_file_path)
    return p.with_name(f"{p.stem}_ir.wav")
