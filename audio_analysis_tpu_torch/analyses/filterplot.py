"""
Filter frequency response, magnitude and phase (audio_analysis_tpu/
analyses/filterplot.py, analysis and summary; the figure is not ported
yet): one rfft per channel (ops.spectral.segment_spectrum) gives the dB
magnitude, the phase (unwrapped by default, in degrees or radians), the
peak within [f_min, f_max] and the magnitude at the bin nearest 1 kHz.

`exact_grid` runs the host float64 numpy version on the reference's exact
segment-length FFT grid instead, as the JAX package does.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from audio_analysis_tpu_torch.analyses._common import (
    FileDsp,
    fetch_packed,
    host_aligned_segments,
    single_channel_dsp,
)
from audio_analysis_tpu_torch.ops import spectral


@dataclass(frozen=True)
class FilterAnalysisSettings:
    use_mono_downmix_for_stereo: bool = False
    trim_to_peak: bool = True
    ignore_leading_seconds: float = 0.0
    analysis_duration_seconds: Optional[float] = None
    use_hann_window: bool = True
    magnitude_floor_db: float = -120.0
    f_min_hz: float = 20.0
    f_max_hz: float = 20000.0
    phase_mode: str = "degrees"  # "degrees" | "radians"
    unwrap_phase: bool = True
    # host float64 numpy on the reference's exact segment-length FFT grid
    exact_grid: bool = False


@dataclass(frozen=True)
class ChannelFilterResponse:
    channel_name: str
    sample_rate_hz: int
    analysis_start_sample_index: int
    analysis_length_samples: int
    frequency_hz: np.ndarray
    magnitude_db: np.ndarray
    phase_response: np.ndarray  # degrees or radians per settings
    peak_frequency_hz: float
    magnitude_at_1khz_db: float


def analyse_filter_response_channels(
    dsp: FileDsp,
    settings: FilterAnalysisSettings,
) -> List[ChannelFilterResponse]:
    """All channels in one batched magnitude + phase spectrum."""
    sample_rate_hz = dsp.sample_rate_hz
    trim_key = (settings.trim_to_peak, settings.ignore_leading_seconds, settings.analysis_duration_seconds)
    aligned = dsp.aligned(*trim_key)
    starts, seg_lens = dsp.aligned_host_meta(*trim_key)
    if int(seg_lens.min()) < 32:
        raise ValueError("Not enough samples after trimming/selection to analyse filter response.")

    if settings.exact_grid:
        return _analyse_exact_grid(dsp, settings)

    spec = spectral.segment_spectrum(
        aligned.samples,
        aligned.length,
        sample_rate_hz,
        use_hann_window=settings.use_hann_window,
        magnitude_floor_db=settings.magnitude_floor_db,
        f_min_hz=float(np.clip(settings.f_min_hz, 0.0, 0.5 * sample_rate_hz)),
        f_max_hz=settings.f_max_hz,
        unwrap_phase=settings.unwrap_phase,
    )
    mag_all, phase_all, peak_all, at1k_all = fetch_packed(
        spec.mag_db, spec.phase, spec.peak_frequency_hz, spec.magnitude_at_1khz_db
    )
    if settings.phase_mode == "degrees":
        phase_all = np.rad2deg(phase_all)
    freq_hz = np.fft.rfftfreq(dsp.bucket_samples, d=1.0 / sample_rate_hz).astype(np.float32)

    return [
        ChannelFilterResponse(
            channel_name=channel_name,
            sample_rate_hz=int(sample_rate_hz),
            analysis_start_sample_index=int(starts[i]),
            analysis_length_samples=int(seg_lens[i]),
            frequency_hz=freq_hz,
            magnitude_db=mag_all[i].astype(np.float32),
            phase_response=phase_all[i].astype(np.float32),
            peak_frequency_hz=float(peak_all[i]),
            magnitude_at_1khz_db=float(at1k_all[i]),
        )
        for i, channel_name in enumerate(dsp.channel_names)
    ]


def _analyse_exact_grid(
    dsp: FileDsp,
    settings: FilterAnalysisSettings,
) -> List[ChannelFilterResponse]:
    """
    Host float64 numpy on the reference's exact segment-length FFT grid:
    rfft of the Hann-windowed exact segment, dB floor, phase (unwrap,
    degrees or radians), peak within the selected range, magnitude at the
    bin nearest 1 kHz.
    """
    sample_rate_hz = dsp.sample_rate_hz
    segments, starts, seg_lens = host_aligned_segments(
        dsp, settings.trim_to_peak, settings.ignore_leading_seconds,
        settings.analysis_duration_seconds,
    )
    floor_lin = 10.0 ** (float(settings.magnitude_floor_db) / 20.0)
    nyquist = 0.5 * float(sample_rate_hz)
    f_min = float(np.clip(settings.f_min_hz, 0.0, nyquist))
    f_max = float(np.clip(settings.f_max_hz, f_min, nyquist))

    results = []
    for i, (channel_name, x) in enumerate(zip(dsp.channel_names, segments)):
        n = int(x.size)
        xw = x * np.hanning(n) if settings.use_hann_window else x
        spectrum = np.fft.rfft(xw)
        mag_db = (20.0 * np.log10(np.maximum(np.abs(spectrum), floor_lin))).astype(np.float32)
        phase = np.angle(spectrum)
        if settings.unwrap_phase:
            phase = np.unwrap(phase)
        if settings.phase_mode == "degrees":
            phase = np.rad2deg(phase)
        freq_hz = np.fft.rfftfreq(n, d=1.0 / float(sample_rate_hz)).astype(np.float32)

        sel = (freq_hz >= f_min) & (freq_hz <= f_max)
        if not np.any(sel):
            raise ValueError("Selected frequency range is empty.")
        peak_freq = float(freq_hz[sel][int(np.argmax(mag_db[sel]))])
        at_1k = float(mag_db[int(np.argmin(np.abs(freq_hz - 1000.0)))])

        results.append(
            ChannelFilterResponse(
                channel_name=channel_name,
                sample_rate_hz=int(sample_rate_hz),
                analysis_start_sample_index=int(starts[i]),
                analysis_length_samples=int(seg_lens[i]),
                frequency_hz=freq_hz,
                magnitude_db=mag_db,
                phase_response=phase.astype(np.float32),
                peak_frequency_hz=peak_freq,
                magnitude_at_1khz_db=at_1k,
            )
        )
    return results


def analyse_filter_response_for_channel(
    samples: np.ndarray,
    sample_rate_hz: int,
    channel_name: str,
    settings: FilterAnalysisSettings,
    device: "str | torch.device" = "cuda",
) -> ChannelFilterResponse:
    return analyse_filter_response_channels(
        single_channel_dsp(samples, sample_rate_hz, channel_name, device), settings
    )[0]


def analyse_filter_response_from_wav_file(
    input_wav_file_path: str | Path,
    settings: Optional[FilterAnalysisSettings] = None,
    dsp: Optional[FileDsp] = None,
    device: "str | torch.device" = "cuda",
) -> List[ChannelFilterResponse]:
    if settings is None:
        settings = FilterAnalysisSettings()
    if dsp is None:
        dsp = FileDsp.from_wav_file(input_wav_file_path, settings.use_mono_downmix_for_stereo, device)
    return analyse_filter_response_channels(dsp, settings)


def summarise_filter_response_results_text(channel_results: List[ChannelFilterResponse]) -> str:
    return "\n".join(
        f"[{r.channel_name}] start_sample={r.analysis_start_sample_index}  "
        f"len_samples={r.analysis_length_samples}  "
        f"peak={r.peak_frequency_hz:.1f}Hz  @1kHz={r.magnitude_at_1khz_db:.1f}dB"
        for r in channel_results
    )
