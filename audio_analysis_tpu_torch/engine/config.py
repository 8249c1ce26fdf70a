"""
Static analysis configuration of the engine: the JAX package's
`audio_analysis_tpu.engine.batch.EngineConfig` with the same fields and
defaults (the report defaults of the reference), minus its four TPU-only
knobs — `use_pallas_edc`, `stft_fft_impl`, `stft_fft_precision` and
`modal_fft_n1` choose between TPU kernel variants; the port always runs its
CUDA kernels on a card.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

TPU_ONLY_FIELDS = ("use_pallas_edc", "stft_fft_impl", "stft_fft_precision", "modal_fft_n1")


@dataclass(frozen=True)
class EngineConfig:
    sample_rate_hz: int = 48_000
    trim_to_peak: bool = True
    ignore_leading_seconds: float = 0.0

    # decay (decay.py:44-73)
    edc_floor_db: float = -120.0
    edc_epsilon: float = 1e-20
    fit_lower_limit_db: float = -80.0
    t20_range_db: Tuple[float, float] = (-5.0, -25.0)
    t30_range_db: Tuple[float, float] = (-5.0, -35.0)
    edt_range_db: Tuple[float, float] = (0.0, -10.0)

    # rt60 bands (rt60bands.py:44-69): "three" | "octave" | "third"
    band_mode: str = "three"
    low_upper_hz: float = 250.0
    mid_center_hz: float = 1000.0
    mid_width_octaves: float = 2.0
    high_lower_hz: float = 4000.0
    band_f_min_hz: float = 31.5
    band_f_max_hz: float = 16000.0
    transition_width_octaves: float = 1.0 / 6.0
    # spectrum-crop decimation of low bands (fftmask.band_decimation_factors):
    # at the default edges and N = 2^20 the Low band's inverse FFT, EDC and
    # fit planes shrink 32x and Mid's 4x. Band samples are exact; the EDC
    # partial sums differ by boundary terms that grow with k, and fits on
    # noise-like narrowband content move by percents under any change of
    # grid, so it stays opt-in as in the JAX package.
    bands_decimate: bool = False

    # spectra
    f_min_hz: float = 20.0
    f_max_hz: float = 20000.0
    magnitude_floor_db: float = -120.0

    # stft (spectrogram.py:51-53) + modal cloud (modalcloud.py:56)
    n_fft: int = 4096
    hop_length: int = 512
    modal_n_fft: int = 8192
    modal_log_bins_per_octave: int = 24
    modal_min_bins: int = 24
    modal_min_fit_points: int = 10
    modal_min_peak_db_above_floor: float = 20.0
    # stop the modal STFT at the last rfft bin any log bin uses
    modal_trim_bins: bool = True

    # diffusion with the report defaults (report.py:360-361)
    diffusion_window_seconds: float = 0.050
    diffusion_hop_seconds: float = 0.05
    diffusion_max_lag_ms: float = 5.0
    echo_density_threshold_rms: float = 1.0

    # 0.5*(L+R) downmix on the device before analysis
    downmix_to_mono: bool = False

    # toggles (heavier blocks can be dropped for pure decay workloads)
    run_bands: bool = True
    run_fr: bool = True
    run_group_delay: bool = True
    run_stft: bool = True
    run_modal: bool = True
    run_diffusion: bool = True


def config_from_jax(cfg) -> EngineConfig:
    """The port's EngineConfig from any dataclass with the JAX fields
    (audio_analysis_tpu.engine.EngineConfig), dropping the TPU-only knobs."""
    fields = dataclasses.asdict(cfg)
    for name in TPU_ONLY_FIELDS:
        fields.pop(name, None)
    return EngineConfig(**fields)
