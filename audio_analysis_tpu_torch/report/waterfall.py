"""
Waterfall slice policy used by the engine summaries: numpy copies of
`WaterfallAnalysisSettings` and `select_slice_frame_indices` from
audio_analysis_tpu/analyses/waterfall.py (that module imports matplotlib
and jax). Tests hold them equal to the originals.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class WaterfallAnalysisSettings:
    use_mono_downmix_for_stereo: bool = False
    trim_to_peak: bool = True
    ignore_leading_seconds: float = 0.0
    analysis_duration_seconds: Optional[float] = None
    n_fft: int = 4096
    hop_length: int = 512
    use_hann_window: bool = True
    f_min_hz: float = 20.0
    f_max_hz: float = 20000.0
    slice_mode: str = "auto"  # "auto" | "uniform_time" | "uniform_frames"
    num_slices: int = 18
    slice_spacing_seconds: float = 0.05
    start_time_seconds: float = 0.0
    end_time_seconds: Optional[float] = None
    db_reference: str = "global_max"  # "global_max" | "slice_max"
    smoothing_log_bins: int = 0
    log_bins_per_octave: int = 96
    dynamic_range_db: float = 80.0
    floor_db: float = -120.0


def select_slice_frame_indices(
    frame_times_seconds: np.ndarray,
    settings: WaterfallAnalysisSettings,
) -> np.ndarray:
    """Ordered unique slice frame indices per slice_mode (host-side)."""
    if frame_times_seconds.size == 0:
        return np.zeros((0,), dtype=np.int32)

    start_t = float(max(0.0, settings.start_time_seconds))
    end_t = (
        float(settings.end_time_seconds)
        if settings.end_time_seconds is not None
        else float(frame_times_seconds[-1])
    )
    if end_t <= start_t:
        end_t = float(frame_times_seconds[-1])

    in_range = (frame_times_seconds >= start_t) & (frame_times_seconds <= end_t)
    if not np.any(in_range):
        return np.zeros((0,), dtype=np.int32)

    idx_min = int(np.argmax(in_range))
    idx_max = int(np.max(np.nonzero(in_range)))
    mode = str(settings.slice_mode).lower()

    if mode == "uniform_frames":
        count = int(max(1, settings.num_slices))
        return np.unique(np.linspace(idx_min, idx_max, count).astype(np.int32))

    if mode == "uniform_time":
        spacing = float(max(1e-4, settings.slice_spacing_seconds))
        targets = np.arange(start_t, end_t + 1e-9, spacing)
    else:  # auto
        count = int(max(2, settings.num_slices))
        targets = np.linspace(start_t, end_t, count)

    indices = [
        j
        for t in targets
        if idx_min <= (j := int(np.argmin(np.abs(frame_times_seconds - float(t))))) <= idx_max
    ]
    if not indices:
        indices = [idx_min, idx_max]
    return np.unique(np.array(indices, dtype=np.int32))
