"""
Group delay vs frequency (audio_analysis_tpu/analyses/group_delay.py):
gd(w) = -dphi/dw in samples from the unwrapped rfft phase, optional bin
smoothing, the median / p10 / p90 summary, and one figure per channel
`<basename>_groupdelay_<CH>.png`.

The FFT (torch.fft) runs at the padded bucket length capped at 2^20, or
at `fft_size` (the aligned segment cut or zero-padded to it on the
device). `exact_grid` runs the host float64 numpy version at the
reference's FFT size (next power of two of the segment, capped at 2^20)
instead, as the JAX package does. matplotlib is imported by the figure
function only.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from audio_analysis_tpu_torch.analyses._common import (
    FileDsp,
    host_aligned_segments,
    single_channel_dsp,
    suffixed_png,
)
from audio_analysis_tpu_torch.ops import spectral

_MAX_FFT = 1 << 20


@dataclass(frozen=True)
class GroupDelayAnalysisSettings:
    use_mono_downmix_for_stereo: bool = False
    trim_to_peak: bool = True
    ignore_leading_seconds: float = 0.0
    analysis_duration_seconds: Optional[float] = None
    use_hann_window: bool = True
    fft_size: Optional[int] = None  # None -> the bucket length (capped 2^20)
    f_min_hz: float = 20.0
    f_max_hz: float = 20000.0
    unwrap_phase: bool = True
    smoothing_bins: int = 0
    # host float64 numpy at the reference's exact FFT size
    exact_grid: bool = False


@dataclass(frozen=True)
class GroupDelayPlotSettings:
    secondary_channel_alpha: float = 0.7
    ylim_samples: Optional[Tuple[float, float]] = None
    show_zero_line: bool = True


@dataclass(frozen=True)
class ChannelGroupDelayResult:
    channel_name: str
    sample_rate_hz: int
    frequency_hz: np.ndarray
    group_delay_samples: np.ndarray


def analyse_group_delay_channels(
    dsp: FileDsp,
    settings: GroupDelayAnalysisSettings,
) -> List[ChannelGroupDelayResult]:
    """All channels in one batched phase / gradient pass."""
    sample_rate_hz = dsp.sample_rate_hz
    if settings.exact_grid:
        return _analyse_exact_grid(dsp, settings)
    aligned = dsp.aligned(
        settings.trim_to_peak, settings.ignore_leading_seconds, settings.analysis_duration_seconds
    )
    n_fft = min(dsp.bucket_samples, _MAX_FFT) if settings.fft_size is None else int(settings.fft_size)
    samples, length = aligned.samples, aligned.length
    if n_fft != dsp.bucket_samples:
        take = min(n_fft, dsp.bucket_samples)
        samples = torch.zeros((samples.shape[0], n_fft), dtype=samples.dtype, device=samples.device)
        samples[:, :take] = aligned.samples[:, :take]
        length = torch.clamp(length, max=take)

    r = spectral.group_delay(
        samples,
        length,
        sample_rate_hz,
        use_hann_window=settings.use_hann_window,
        unwrap=settings.unwrap_phase,
        smoothing_bins=int(settings.smoothing_bins),
        f_min_hz=float(settings.f_min_hz),
        f_max_hz=float(settings.f_max_hz),
    )
    freq_hz = np.fft.rfftfreq(n_fft, d=1.0 / sample_rate_hz)
    sel = (freq_hz >= settings.f_min_hz) & (freq_hz <= settings.f_max_hz)
    gd_all = r.group_delay_samples.cpu().numpy()  # (C, F)
    return [
        ChannelGroupDelayResult(
            channel_name=channel_name,
            sample_rate_hz=int(sample_rate_hz),
            frequency_hz=freq_hz[sel].astype(np.float64),
            group_delay_samples=gd_all[i][sel].astype(np.float64),
        )
        for i, channel_name in enumerate(dsp.channel_names)
    ]


def _analyse_exact_grid(
    dsp: FileDsp,
    settings: GroupDelayAnalysisSettings,
) -> List[ChannelGroupDelayResult]:
    """
    Host float64 numpy as the reference computes it: Hann over the exact
    segment, rfft at the next power of two of the segment length (capped
    at 2^20), unwrap, gd = -dphi/dw in samples, optional moving-average
    smoothing, then the frequency-range mask.
    """
    sample_rate_hz = dsp.sample_rate_hz
    segments, _, _ = host_aligned_segments(
        dsp, settings.trim_to_peak, settings.ignore_leading_seconds,
        settings.analysis_duration_seconds,
    )

    results = []
    for channel_name, x in zip(dsp.channel_names, segments):
        seg = x * np.hanning(x.size) if settings.use_hann_window else x
        if settings.fft_size is None:
            n_fft = 1 << max(0, int(np.ceil(np.log2(max(1, seg.size)))))
            n_fft = min(n_fft, _MAX_FFT)
        else:
            n_fft = int(settings.fft_size)

        spectrum = np.fft.rfft(seg, n=n_fft)
        freq_hz = np.fft.rfftfreq(n_fft, d=1.0 / float(sample_rate_hz))
        phase = np.angle(spectrum)
        if settings.unwrap_phase:
            phase = np.unwrap(phase)
        w = 2.0 * np.pi * (freq_hz / float(sample_rate_hz))  # rad/sample
        gd = -np.gradient(phase, w)
        if settings.smoothing_bins and int(settings.smoothing_bins) > 1:
            kernel = np.ones(int(settings.smoothing_bins)) / float(settings.smoothing_bins)
            gd = np.convolve(gd, kernel, mode="same")

        sel = (freq_hz >= float(settings.f_min_hz)) & (freq_hz <= float(settings.f_max_hz))
        results.append(
            ChannelGroupDelayResult(
                channel_name=channel_name,
                sample_rate_hz=int(sample_rate_hz),
                frequency_hz=freq_hz[sel].astype(np.float64),
                group_delay_samples=gd[sel].astype(np.float64),
            )
        )
    return results


def analyse_group_delay_for_channel(
    samples: np.ndarray,
    sample_rate_hz: int,
    channel_name: str,
    settings: GroupDelayAnalysisSettings,
    device: "str | torch.device" = "cuda",
) -> ChannelGroupDelayResult:
    return analyse_group_delay_channels(
        single_channel_dsp(samples, sample_rate_hz, channel_name, device), settings
    )[0]


def analyse_group_delay_from_wav_file(
    input_wav_file_path: str | Path,
    settings: Optional[GroupDelayAnalysisSettings] = None,
    dsp: Optional[FileDsp] = None,
    device: "str | torch.device" = "cuda",
) -> List[ChannelGroupDelayResult]:
    if settings is None:
        settings = GroupDelayAnalysisSettings()
    if dsp is None:
        dsp = FileDsp.from_wav_file(input_wav_file_path, settings.use_mono_downmix_for_stereo, device)
    return analyse_group_delay_channels(dsp, settings)


def render_group_delay_plots(
    results: List[ChannelGroupDelayResult],
    plot_settings: GroupDelayPlotSettings,
    output_basename: Optional[str | Path],
    show_interactive: bool,
) -> None:
    """Figures and save only (host matplotlib); results come from
    analyse_*. Every figure goes through the line-figure template."""
    import matplotlib.ticker as mticker

    from audio_analysis_tpu_torch import plot

    def setup(ax):
        ax.set_xscale("log")
        ax.set_xlabel("Frequency (Hz)")
        ax.set_ylabel("Group delay (samples)")
        ax.xaxis.set_major_formatter(mticker.ScalarFormatter())
        ax.xaxis.set_minor_locator(mticker.NullLocator())  # majors carry the scale
        if plot_settings.ylim_samples is not None:
            ax.set_ylim(*plot_settings.ylim_samples)

    def build_extras(ax):
        if plot_settings.show_zero_line:
            ax.axhline(0.0, linestyle="--", linewidth=1.0)

    for result in results:
        f_plot, g_plot = plot.decimate_minmax_log(
            result.frequency_hz,
            result.group_delay_samples,
            float(result.frequency_hz[0]) if result.frequency_hz.size else 1.0,
            float(result.frequency_hz[-1]) if result.frequency_hz.size else 2.0,
        )
        output_path = (
            None if output_basename is None else suffixed_png(output_basename, f"_groupdelay_{result.channel_name}")
        )
        plot.render_line_figure(
            "group_delay",
            (plot_settings,),
            f"Group delay ({result.channel_name})",
            [(f_plot, g_plot, {})],
            output_path,
            show_interactive,
            setup=setup,
            build_extras=build_extras,
        )


def plot_group_delay_from_wav_file(
    input_wav_file_path: str | Path,
    settings: Optional[GroupDelayAnalysisSettings] = None,
    plot_settings: Optional[GroupDelayPlotSettings] = None,
    output_basename: Optional[str | Path] = None,
    show_interactive: bool = True,
    dsp: Optional[FileDsp] = None,
    device: "str | torch.device" = "cuda",
) -> List[ChannelGroupDelayResult]:
    if settings is None:
        settings = GroupDelayAnalysisSettings()
    if plot_settings is None:
        plot_settings = GroupDelayPlotSettings()
    results = analyse_group_delay_from_wav_file(input_wav_file_path, settings, dsp=dsp, device=device)
    render_group_delay_plots(results, plot_settings, output_basename, show_interactive)
    return results


def summarise_group_delay_results_text(results: List[ChannelGroupDelayResult]) -> str:
    lines: List[str] = []
    for r in results:
        gd = r.group_delay_samples
        if gd.size == 0:
            continue
        lines.append(
            f"- {r.channel_name}: gd median={float(np.median(gd)):.3f} samples, "
            f"p10={float(np.percentile(gd, 10)):.3f}, p90={float(np.percentile(gd, 90)):.3f}"
        )
    if not lines:
        return "No group delay results."
    return "Group delay summary:\n" + "\n".join(lines)
