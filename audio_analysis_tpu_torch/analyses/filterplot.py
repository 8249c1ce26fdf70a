"""
Filter frequency response, magnitude and phase (audio_analysis_tpu/
analyses/filterplot.py): one rfft per channel
(ops.spectral.segment_spectrum) gives the dB magnitude, the phase
(unwrapped by default, in degrees or radians), the peak within [f_min,
f_max] and the magnitude at the bin nearest 1 kHz; the summary, and the
two-panel figure `<basename>_filter.png`.

`exact_grid` runs the host float64 numpy version on the reference's exact
segment-length FFT grid instead, as the JAX package does. matplotlib is
imported by the figure functions only.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from audio_analysis_tpu_torch.analyses._common import (
    FileDsp,
    fetch_packed,
    host_aligned_segments,
    single_channel_dsp,
    suffixed_png,
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
class FilterPlotSettings:
    secondary_channel_alpha: float = 0.7
    magnitude_ylim_db: Optional[Tuple[float, float]] = None
    phase_ylim: Optional[Tuple[float, float]] = None


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


def plot_filter_response_figure(
    channel_results: List[ChannelFilterResponse],
    analysis_settings: FilterAnalysisSettings,
    plot_settings: FilterPlotSettings,
    title: str,
):
    """Magnitude (dB) above, phase below, on log-frequency axes."""
    import matplotlib.pyplot as plt
    import matplotlib.ticker as mticker

    from audio_analysis_tpu_torch import plot

    if not channel_results:
        raise ValueError("No channel results to plot.")
    nyquist = 0.5 * float(channel_results[0].sample_rate_hz)
    f_min = float(np.clip(analysis_settings.f_min_hz, 1.0, nyquist))
    f_max = float(np.clip(analysis_settings.f_max_hz, f_min, nyquist))

    figure, (ax_mag, ax_phase) = plt.subplots(2, 1, figsize=(10, 8))
    figure.suptitle(title, fontsize=12, fontweight="bold")
    for ax, ylabel in ((ax_mag, "Magnitude (dB)"), (ax_phase, None)):
        ax.set_xscale("log")
        ax.set_xlabel("Frequency (Hz)")
        ax.xaxis.set_major_formatter(mticker.FuncFormatter(lambda v, p: f"{v:.0f}"))
        ax.set_xlim(f_min, f_max)
        ax.grid(True, which="both", linestyle=":", linewidth=0.5)
        if ylabel:
            ax.set_ylabel(ylabel)
    phase_unit = "degrees" if analysis_settings.phase_mode == "degrees" else "radians"
    ax_phase.set_ylabel(f"Phase ({phase_unit})")

    def _sel(r):
        return (r.frequency_hz >= f_min) & (r.frequency_hz <= f_max)

    if plot_settings.magnitude_ylim_db is None:
        y = np.concatenate([r.magnitude_db[_sel(r)] for r in channel_results])
        if y.size:
            ax_mag.set_ylim(np.percentile(y, 1.0) - 6.0, np.percentile(y, 99.5) + 6.0)
    else:
        ax_mag.set_ylim(plot_settings.magnitude_ylim_db)
    if plot_settings.phase_ylim is None:
        ph = np.concatenate([r.phase_response[_sel(r)] for r in channel_results])
        if ph.size:
            lo, hi = np.percentile(ph, 1.0), np.percentile(ph, 99.0)
            margin = (hi - lo) * 0.1
            ax_phase.set_ylim(lo - margin, hi + margin)
    else:
        ax_phase.set_ylim(plot_settings.phase_ylim)

    for idx, r in enumerate(channel_results):
        alpha = 1.0 if idx == 0 else float(plot_settings.secondary_channel_alpha)
        f_mag, m_plot = plot.decimate_minmax_log(r.frequency_hz, r.magnitude_db, f_min, f_max)
        ax_mag.plot(
            f_mag, m_plot, alpha=alpha,
            label=f"{r.channel_name}  peak={r.peak_frequency_hz:.0f}Hz  @1kHz={r.magnitude_at_1khz_db:.1f}dB",
        )
        f_ph, p_plot = plot.decimate_minmax_log(r.frequency_hz, r.phase_response, f_min, f_max)
        ax_phase.plot(f_ph, p_plot, alpha=alpha, label=r.channel_name)
    ax_mag.legend(loc="best", fontsize=9)
    ax_phase.legend(loc="best", fontsize=9)
    plt.tight_layout()
    return figure


def render_filter_response_plots(
    results: List[ChannelFilterResponse],
    analysis_settings: FilterAnalysisSettings,
    plot_settings: FilterPlotSettings,
    output_basename: Optional[str | Path],
    show_interactive: bool,
    title_source: str | Path,
) -> None:
    """Figure and save only (host matplotlib); results come from analyse_*."""
    from audio_analysis_tpu_torch import plot

    figure = plot_filter_response_figure(
        results, analysis_settings, plot_settings, title=f"Filter frequency response — {title_source}"
    )
    output_path = None if output_basename is None else suffixed_png(output_basename, "_filter")
    plot.finalize_and_show_or_save(figure, output_path, show_interactive)


def plot_filter_response_from_wav_file(
    input_wav_file_path: str | Path,
    analysis_settings: Optional[FilterAnalysisSettings] = None,
    plot_settings: Optional[FilterPlotSettings] = None,
    output_basename: Optional[str | Path] = None,
    show_interactive: bool = True,
    device: "str | torch.device" = "cuda",
) -> List[ChannelFilterResponse]:
    if analysis_settings is None:
        analysis_settings = FilterAnalysisSettings()
    if plot_settings is None:
        plot_settings = FilterPlotSettings()
    results = analyse_filter_response_from_wav_file(input_wav_file_path, analysis_settings, device=device)
    render_filter_response_plots(
        results, analysis_settings, plot_settings, output_basename, show_interactive, input_wav_file_path
    )
    return results


def summarise_filter_response_results_text(channel_results: List[ChannelFilterResponse]) -> str:
    return "\n".join(
        f"[{r.channel_name}] start_sample={r.analysis_start_sample_index}  "
        f"len_samples={r.analysis_length_samples}  "
        f"peak={r.peak_frequency_hz:.1f}Hz  @1kHz={r.magnitude_at_1khz_db:.1f}dB"
        for r in channel_results
    )
