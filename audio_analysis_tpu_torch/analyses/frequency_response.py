"""
Frequency response / magnitude spectrum (audio_analysis_tpu/analyses/
frequency_response.py): Hann window over the analysed segment, dB floor,
optional log-frequency smoothing, the peak and the amplitude-weighted
centroid over [f_min, f_max], the summary, and the figure
`<basename>_fr.png` (each channel's spectrum as a log-bucketed min-max
envelope).

One rfft (torch.fft) per channel at the padded bucket length, so the bin
grid is finer than the reference's exact-length FFT, as in the JAX
package. The (C, F) dB plane reaches the host in the 1/128-dB fixed point;
without smoothing the peak and centroid come from the full float32
spectrum on the device, with smoothing from the smoothed host plane.
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
    fetch_db_plane_i16,
    fetch_packed,
    host_aligned_segments,
    single_channel_dsp,
    suffixed_png,
)
from audio_analysis_tpu_torch.ops import logfreq, spectral


@dataclass(frozen=True)
class FrequencyResponseAnalysisSettings:
    use_mono_downmix_for_stereo: bool = False
    trim_to_peak: bool = True
    ignore_leading_seconds: float = 0.0
    analysis_duration_seconds: Optional[float] = None
    use_hann_window: bool = True
    magnitude_floor_db: float = -120.0
    f_min_hz: float = 20.0
    f_max_hz: float = 20000.0
    smoothing_log_bins: int = 0
    log_bins_per_octave: int = 96
    # host float64 numpy on the reference's exact segment-length FFT grid
    exact_grid: bool = False


@dataclass(frozen=True)
class FrequencyResponsePlotSettings:
    secondary_channel_alpha: float = 0.7
    ylim_db: Optional[Tuple[float, float]] = None


@dataclass(frozen=True)
class ChannelFrequencyResponse:
    channel_name: str
    sample_rate_hz: int
    analysis_start_sample_index: int
    analysis_length_samples: int
    frequency_hz: np.ndarray
    magnitude_db: np.ndarray
    peak_frequency_hz: float
    spectral_centroid_hz: float


def analyse_frequency_response_channels(
    dsp: FileDsp,
    settings: FrequencyResponseAnalysisSettings,
) -> List[ChannelFrequencyResponse]:
    """All channels in one batched spectrum."""
    sample_rate_hz = dsp.sample_rate_hz
    aligned = dsp.aligned(
        settings.trim_to_peak, settings.ignore_leading_seconds, settings.analysis_duration_seconds
    )
    starts, seg_lens = dsp.aligned_host_meta(
        settings.trim_to_peak, settings.ignore_leading_seconds, settings.analysis_duration_seconds
    )
    if int(seg_lens.min()) < 32:
        raise ValueError("Not enough samples after trimming/selection to analyse spectrum.")

    nyquist = 0.5 * sample_rate_hz
    f_min = float(np.clip(settings.f_min_hz, 0.0, nyquist))
    f_max = float(np.clip(settings.f_max_hz, f_min, nyquist))
    if settings.exact_grid:
        return _analyse_exact_grid(dsp, settings, f_min, f_max)

    spec = spectral.segment_spectrum(
        aligned.samples,
        aligned.length,
        sample_rate_hz,
        use_hann_window=settings.use_hann_window,
        magnitude_floor_db=settings.magnitude_floor_db,
        f_min_hz=f_min,
        f_max_hz=f_max,
        unwrap_phase=False,
    )
    freq_hz = np.fft.rfftfreq(dsp.bucket_samples, d=1.0 / sample_rate_hz).astype(np.float32)
    mag_db_all = fetch_db_plane_i16(spec.mag_db)
    sel = (freq_hz >= f_min) & (freq_hz <= f_max)
    if not np.any(sel):
        raise ValueError("Selected frequency range is empty (check f_min_hz/f_max_hz).")

    smoothed = settings.smoothing_log_bins and int(settings.smoothing_log_bins) > 1
    if smoothed:
        f_min_s = float(np.clip(settings.f_min_hz, 1.0, nyquist))
        f_max_s = float(np.clip(settings.f_max_hz, f_min_s, nyquist))
        mag_db_all = logfreq.smooth_mag_db_log_frequency(
            freq_hz,
            torch.from_numpy(mag_db_all),
            f_min_s,
            f_max_s,
            int(settings.smoothing_log_bins),
            int(settings.log_bins_per_octave),
        ).numpy()
    else:
        peak_all, centroid_all = fetch_packed(spec.peak_frequency_hz, spec.spectral_centroid_hz)

    results = []
    for i, channel_name in enumerate(dsp.channel_names):
        mag_db = mag_db_all[i]
        if smoothed:
            # the diagnostics of the smoothed curve (fr:238-260)
            mag_sel_lin = 10.0 ** (mag_db[sel].astype(np.float64) / 20.0)
            peak_freq = float(freq_hz[sel][np.argmax(mag_db[sel])])
            wsum = float(mag_sel_lin.sum())
            centroid = float((freq_hz[sel] * mag_sel_lin).sum() / wsum) if wsum > 0 else float(freq_hz[sel][0])
        else:
            peak_freq = float(peak_all[i])
            centroid = float(centroid_all[i])
        results.append(
            ChannelFrequencyResponse(
                channel_name=channel_name,
                sample_rate_hz=int(sample_rate_hz),
                analysis_start_sample_index=int(starts[i]),
                analysis_length_samples=int(seg_lens[i]),
                frequency_hz=freq_hz,
                magnitude_db=mag_db.astype(np.float32),
                peak_frequency_hz=peak_freq,
                spectral_centroid_hz=centroid,
            )
        )
    return results


def _analyse_exact_grid(
    dsp: FileDsp,
    settings: FrequencyResponseAnalysisSettings,
    f_min: float,
    f_max: float,
) -> List[ChannelFrequencyResponse]:
    """
    Host float64 numpy on the reference's exact segment-length FFT grid:
    rfft of the Hann-windowed exact segment, dB floor, peak and centroid
    over the selected range. Log-frequency smoothing runs ops.logfreq on
    the host on that grid.
    """
    sample_rate_hz = dsp.sample_rate_hz
    segments, starts, seg_lens = host_aligned_segments(
        dsp, settings.trim_to_peak, settings.ignore_leading_seconds,
        settings.analysis_duration_seconds,
    )
    floor_lin = 10.0 ** (float(settings.magnitude_floor_db) / 20.0)
    smoothed = settings.smoothing_log_bins and int(settings.smoothing_log_bins) > 1

    results = []
    for i, (channel_name, x) in enumerate(zip(dsp.channel_names, segments)):
        n = int(x.size)
        xw = x * np.hanning(n) if settings.use_hann_window else x
        mag = np.maximum(np.abs(np.fft.rfft(xw)), floor_lin)
        mag_db = (20.0 * np.log10(mag)).astype(np.float32)
        freq_hz = np.fft.rfftfreq(n, d=1.0 / float(sample_rate_hz)).astype(np.float32)

        if smoothed:
            nyq = 0.5 * float(sample_rate_hz)
            f_min_s = float(np.clip(settings.f_min_hz, 1.0, nyq))
            f_max_s = float(np.clip(settings.f_max_hz, f_min_s, nyq))
            mag_db = logfreq.smooth_mag_db_log_frequency(
                freq_hz,
                torch.from_numpy(mag_db[None, :]),
                f_min_s,
                f_max_s,
                int(settings.smoothing_log_bins),
                int(settings.log_bins_per_octave),
            ).numpy()[0]

        sel = (freq_hz >= f_min) & (freq_hz <= f_max)
        if not np.any(sel):
            raise ValueError("Selected frequency range is empty (check f_min_hz/f_max_hz).")
        mag_sel_db = mag_db[sel]
        mag_sel_lin = 10.0 ** (mag_sel_db.astype(np.float64) / 20.0)
        peak_freq = float(freq_hz[sel][int(np.argmax(mag_sel_db))])
        wsum = float(mag_sel_lin.sum())
        centroid = (
            float((freq_hz[sel].astype(np.float64) * mag_sel_lin).sum() / wsum)
            if wsum > 0.0
            else float(freq_hz[sel][0])
        )

        results.append(
            ChannelFrequencyResponse(
                channel_name=channel_name,
                sample_rate_hz=int(sample_rate_hz),
                analysis_start_sample_index=int(starts[i]),
                analysis_length_samples=int(seg_lens[i]),
                frequency_hz=freq_hz,
                magnitude_db=mag_db.astype(np.float32),
                peak_frequency_hz=peak_freq,
                spectral_centroid_hz=centroid,
            )
        )
    return results


def analyse_frequency_response_for_channel(
    samples: np.ndarray,
    sample_rate_hz: int,
    channel_name: str,
    settings: FrequencyResponseAnalysisSettings,
    device: "str | torch.device" = "cuda",
) -> ChannelFrequencyResponse:
    return analyse_frequency_response_channels(
        single_channel_dsp(samples, sample_rate_hz, channel_name, device), settings
    )[0]


def analyse_frequency_response_from_wav_file(
    input_wav_file_path: str | Path,
    settings: Optional[FrequencyResponseAnalysisSettings] = None,
    dsp: Optional[FileDsp] = None,
    device: "str | torch.device" = "cuda",
) -> List[ChannelFrequencyResponse]:
    if settings is None:
        settings = FrequencyResponseAnalysisSettings()
    if dsp is None:
        dsp = FileDsp.from_wav_file(input_wav_file_path, settings.use_mono_downmix_for_stereo, device)
    return analyse_frequency_response_channels(dsp, settings)


def _fr_band_limits(
    channel_results: List[ChannelFrequencyResponse],
    analysis_settings: FrequencyResponseAnalysisSettings,
) -> Tuple[float, float]:
    nyquist = 0.5 * float(channel_results[0].sample_rate_hz)
    f_min = float(np.clip(analysis_settings.f_min_hz, 1.0, nyquist))
    f_max = float(np.clip(analysis_settings.f_max_hz, f_min, nyquist))
    return f_min, f_max


def _fr_plot_lines(
    channel_results: List[ChannelFrequencyResponse],
    plot_settings: FrequencyResponsePlotSettings,
    f_min: float,
    f_max: float,
) -> List[tuple]:
    """(x, y, Line2D kwargs) of the FR figure: each spectrum as a
    log-bucketed min-max envelope of display resolution."""
    from audio_analysis_tpu_torch import plot

    lines: List[tuple] = []
    for idx, r in enumerate(channel_results):
        alpha = 1.0 if idx == 0 else float(plot_settings.secondary_channel_alpha)
        f_plot, m_plot = plot.decimate_minmax_log(r.frequency_hz, r.magnitude_db, f_min, f_max)
        label = f"{r.channel_name}  peak={r.peak_frequency_hz:.0f}Hz  centroid={r.spectral_centroid_hz:.0f}Hz"
        lines.append((f_plot, m_plot, {"alpha": alpha, "label": label}))
    return lines


def _fr_axis_setup(
    axis,
    channel_results: List[ChannelFrequencyResponse],
    plot_settings: FrequencyResponsePlotSettings,
    f_min: float,
    f_max: float,
) -> None:
    """The static FR axis configuration, idempotent (both render paths)."""
    import matplotlib.ticker as mticker

    from audio_analysis_tpu_torch import plot

    axis.set_xscale("log")
    axis.set_xticks([20, 50, 100, 200, 500, 1000, 2000, 5000, 10000, 20000])
    axis.xaxis.set_major_formatter(mticker.FuncFormatter(plot.hz_tick_formatter))
    axis.xaxis.set_minor_locator(mticker.NullLocator())  # majors carry the scale
    axis.set_xlabel("Frequency (Hz)")
    plot.label_decibel_axis(axis)
    if plot_settings.ylim_db is not None:
        axis.set_ylim(*plot_settings.ylim_db)
    else:
        vals = [r.magnitude_db[(r.frequency_hz >= f_min) & (r.frequency_hz <= f_max)] for r in channel_results]
        y = np.concatenate(vals) if vals else np.array([], np.float32)
        if y.size:
            axis.set_ylim(float(np.percentile(y, 1.0)) - 6.0, float(np.percentile(y, 99.5)) + 6.0)
    axis.set_xlim(f_min, f_max)
    axis.grid(True, which="both", linestyle=":", linewidth=0.5)


def plot_frequency_response_figure(
    channel_results: List[ChannelFrequencyResponse],
    analysis_settings: FrequencyResponseAnalysisSettings,
    plot_settings: FrequencyResponsePlotSettings,
    title: Optional[str] = None,
):
    from audio_analysis_tpu_torch import plot

    figure, axis = plot.create_figure_and_axis(title=title)
    f_min, f_max = _fr_band_limits(channel_results, analysis_settings)
    for x, y, props in _fr_plot_lines(channel_results, plot_settings, f_min, f_max):
        axis.plot(x, y, **props)
    _fr_axis_setup(axis, channel_results, plot_settings, f_min, f_max)
    axis.legend(loc="best")
    return figure


def render_frequency_response_plots(
    results: List[ChannelFrequencyResponse],
    analysis_settings: FrequencyResponseAnalysisSettings,
    plot_settings: FrequencyResponsePlotSettings,
    output_basename: Optional[str | Path],
    show_interactive: bool,
    title_source: str | Path,
) -> None:
    """Figure and save only (host matplotlib); results come from analyse_*.
    The saved figure goes through the line-figure template, which mirrors
    plot_frequency_response_figure."""
    from audio_analysis_tpu_torch import plot

    title = f"Frequency response (spectrum) — {title_source}"
    output_path = None if output_basename is None else suffixed_png(output_basename, "_fr")
    if output_path is None or show_interactive:
        figure = plot_frequency_response_figure(results, analysis_settings, plot_settings, title=title)
        plot.finalize_and_show_or_save(figure, output_path, show_interactive)
        return

    f_min, f_max = _fr_band_limits(results, analysis_settings)

    def setup(axis):
        _fr_axis_setup(axis, results, plot_settings, f_min, f_max)

    plot.render_line_figure(
        "frequency_response",
        (analysis_settings, plot_settings, int(results[0].sample_rate_hz), len(results)),
        title,
        _fr_plot_lines(results, plot_settings, f_min, f_max),
        output_path,
        show_interactive,
        legend_kwargs={"loc": "best"},
        setup=setup,
    )


def plot_frequency_response_from_wav_file(
    input_wav_file_path: str | Path,
    analysis_settings: Optional[FrequencyResponseAnalysisSettings] = None,
    plot_settings: Optional[FrequencyResponsePlotSettings] = None,
    output_basename: Optional[str | Path] = None,
    show_interactive: bool = True,
    dsp: Optional[FileDsp] = None,
    device: "str | torch.device" = "cuda",
) -> List[ChannelFrequencyResponse]:
    if analysis_settings is None:
        analysis_settings = FrequencyResponseAnalysisSettings()
    if plot_settings is None:
        plot_settings = FrequencyResponsePlotSettings()
    results = analyse_frequency_response_from_wav_file(input_wav_file_path, analysis_settings, dsp=dsp, device=device)
    render_frequency_response_plots(
        results, analysis_settings, plot_settings, output_basename, show_interactive, input_wav_file_path
    )
    return results


def summarise_frequency_response_results_text(channel_results: List[ChannelFrequencyResponse]) -> str:
    return "\n".join(
        f"[{r.channel_name}] start_sample={r.analysis_start_sample_index}  "
        f"len_samples={r.analysis_length_samples}  "
        f"peak={r.peak_frequency_hz:.1f}Hz  centroid={r.spectral_centroid_hz:.1f}Hz"
        for r in channel_results
    )
