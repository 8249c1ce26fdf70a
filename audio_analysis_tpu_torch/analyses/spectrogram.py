"""
Spectrogram (time-frequency magnitude) analysis and summary
(audio_analysis_tpu/analyses/spectrogram.py; the figure and its
display-resolution pooling are not ported yet): n_fft 4096, hop 512,
Hann, floor -120 dB, valid framing.

The dB plane of every channel is one call of kernel K2 (ops.stft) through
the file's memoised STFT, and reaches the host in the 1/128-dB fixed point.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from audio_analysis_tpu_torch.analyses._common import FileDsp, single_channel_dsp
from audio_analysis_tpu_torch.ops import stft


@dataclass(frozen=True)
class SpectrogramAnalysisSettings:
    use_mono_downmix_for_stereo: bool = False
    trim_to_peak: bool = True
    ignore_leading_seconds: float = 0.0
    analysis_duration_seconds: Optional[float] = None
    n_fft: int = 4096
    hop_length: int = 512
    use_hann_window: bool = True
    floor_db: float = -120.0
    f_min_hz: float = 20.0
    f_max_hz: float = 20000.0
    dynamic_range_db: Optional[float] = 90.0


@dataclass(frozen=True)
class ChannelSpectrogramResult:
    channel_name: str
    sample_rate_hz: int
    analysis_start_sample_index: int
    analysis_length_samples: int
    time_seconds: np.ndarray  # (T,)
    frequency_hz: np.ndarray  # (F,)
    magnitude_db: np.ndarray  # (F, T)
    # the display-resolution image of the plot path (not ported yet)
    display: Optional[object] = None


def analyse_spectrogram_channels(
    dsp: FileDsp,
    settings: SpectrogramAnalysisSettings,
) -> List[ChannelSpectrogramResult]:
    """All channels from the file's shared STFT (one kernel launch)."""
    if settings.n_fft <= 0 or settings.hop_length <= 0:
        raise ValueError("n_fft and hop_length must be positive.")
    starts, seg_lens = dsp.aligned_host_meta(
        settings.trim_to_peak, settings.ignore_leading_seconds, settings.analysis_duration_seconds
    )
    if int(seg_lens.min()) < settings.n_fft:
        raise ValueError("Not enough samples after trimming/selection for spectrogram (need at least n_fft).")

    mag_all, num_frames = dsp.stft_db_host(
        settings.trim_to_peak,
        settings.ignore_leading_seconds,
        settings.analysis_duration_seconds,
        int(settings.n_fft),
        int(settings.hop_length),
        bool(settings.use_hann_window),
        float(settings.floor_db),
    )
    results = []
    for i, channel_name in enumerate(dsp.channel_names):
        t_valid = int(num_frames[i])
        results.append(
            ChannelSpectrogramResult(
                channel_name=str(channel_name),
                sample_rate_hz=dsp.sample_rate_hz,
                analysis_start_sample_index=int(starts[i]),
                analysis_length_samples=int(seg_lens[i]),
                time_seconds=stft.frame_times_seconds(t_valid, settings.hop_length, dsp.sample_rate_hz),
                frequency_hz=stft.rfft_freqs_hz(settings.n_fft, dsp.sample_rate_hz),
                magnitude_db=mag_all[i][:t_valid].T.astype(np.float32),
            )
        )
    return results


def analyse_spectrogram_for_channel(
    samples: np.ndarray,
    sample_rate_hz: int,
    channel_name: str,
    settings: SpectrogramAnalysisSettings,
    device: "str | torch.device" = "cuda",
) -> ChannelSpectrogramResult:
    return analyse_spectrogram_channels(
        single_channel_dsp(samples, sample_rate_hz, channel_name, device), settings
    )[0]


def analyse_spectrogram_from_wav_file(
    input_wav_file_path: str | Path,
    settings: Optional[SpectrogramAnalysisSettings] = None,
    dsp: Optional[FileDsp] = None,
    device: "str | torch.device" = "cuda",
) -> List[ChannelSpectrogramResult]:
    if settings is None:
        settings = SpectrogramAnalysisSettings()
    if dsp is None:
        dsp = FileDsp.from_wav_file(input_wav_file_path, settings.use_mono_downmix_for_stereo, device)
    return analyse_spectrogram_channels(dsp, settings)


def summarise_spectrogram_results_text(results: List[ChannelSpectrogramResult]) -> str:
    lines = []
    for r in results:
        duration_s = float(r.analysis_length_samples) / float(r.sample_rate_hz)
        n_fft, frames = r.magnitude_db.shape[0] * 2 - 2, r.magnitude_db.shape[1]
        lines.append(
            f"[{r.channel_name}] start_sample={r.analysis_start_sample_index}  "
            f"len_samples={r.analysis_length_samples}  dur={duration_s:.3f}s  "
            f"stft(n_fft={n_fft}, frames={frames})"
        )
    return "\n".join(lines)
