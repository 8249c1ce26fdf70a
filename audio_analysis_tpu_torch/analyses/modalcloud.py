"""
Modal cloud: per-log-frequency-bin RT60 from STFT decay
(audio_analysis_tpu/analyses/modalcloud.py): n_fft 8192 STFT, geometric
log bins (24/oct) averaged in linear magnitude, per-bin curves relative to
their own peak, the same crossing + line fit per bin (at least 10 points,
a peak at least 20 dB above the floor), the summary, and one scatter with
its sliding-median curve per channel `<basename>_modalcloud_<CH>.png`.

The dB plane is one call of kernel K2 through the file's memoised STFT;
the bin means are one float32 matmul and every (channel, bin) fit is one
batched dbfit call. matplotlib is imported by the figure functions only.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from audio_analysis_tpu_torch.analyses._common import FileDsp, fetch_packed, single_channel_dsp, suffixed_png
from audio_analysis_tpu_torch.ops import dbfit, logfreq, stft


@dataclass(frozen=True)
class ModalCloudAnalysisSettings:
    use_mono_downmix_for_stereo: bool = False
    trim_to_peak: bool = True
    ignore_leading_seconds: float = 0.0
    analysis_duration_seconds: Optional[float] = None
    n_fft: int = 8192
    hop_length: int = 512
    use_hann_window: bool = True
    f_min_hz: float = 20.0
    f_max_hz: float = 20000.0
    log_bins_per_octave: int = 24
    min_bins: int = 24
    floor_db: float = -120.0
    fit_lower_limit_db: float = -80.0
    t30_range_db: Tuple[float, float] = (-5.0, -35.0)
    t20_range_db: Tuple[float, float] = (-5.0, -25.0)
    edt_range_db: Tuple[float, float] = (0.0, -10.0)
    metric: str = "t30"  # "t30" | "t20" | "edt"
    min_fit_points: int = 10
    min_peak_db_above_floor: float = 20.0


@dataclass(frozen=True)
class ModalCloudPlotSettings:
    secondary_channel_alpha: float = 0.7
    show_median_curve: bool = True
    median_octave_window: float = 0.25
    ylim_seconds: Optional[Tuple[float, float]] = None


@dataclass(frozen=True)
class ModalPoint:
    centre_hz: float
    rt60_seconds: float
    r_squared: float


@dataclass(frozen=True)
class ChannelModalCloudResult:
    channel_name: str
    sample_rate_hz: int
    analysis_start_sample_index: int
    analysis_length_samples: int
    metric: str
    points: List[ModalPoint]


def _metric_range(settings: ModalCloudAnalysisSettings) -> Tuple[str, Tuple[float, float]]:
    metric = str(settings.metric).lower()
    if metric == "t20":
        return "t20", settings.t20_range_db
    if metric == "edt":
        return "edt", settings.edt_range_db
    return "t30", settings.t30_range_db


def _bin_curves(mag_db_tf: torch.Tensor, bin_matrix: torch.Tensor, num_frames: torch.Tensor):
    """Per-bin curves (C, B, T) relative to each bin's peak, the peaks
    (C, B, 1), and each curve's valid frame count (C, B)."""
    curves_db = logfreq.aggregate_db_to_log_bins(mag_db_tf, bin_matrix)
    peak = curves_db.amax(dim=-1, keepdim=True)
    frame_len = torch.broadcast_to(num_frames[:, None], curves_db.shape[:-1])
    return peak, curves_db - peak, frame_len


def analyse_modal_cloud_channels(
    dsp: FileDsp,
    settings: ModalCloudAnalysisSettings,
) -> List[ChannelModalCloudResult]:
    """
    All channels at once: one STFT, the bin means as one matmul and every
    (channel, bin) fit in one dbfit call. Invalid frames sit at floor_db
    (ops.stft.stft_mag_db), so a bin's peak over all frames is its peak
    over the valid ones; fits mask by each channel's valid frame count.
    """
    sample_rate_hz = dsp.sample_rate_hz
    starts, seg_lens = dsp.aligned_host_meta(
        settings.trim_to_peak, settings.ignore_leading_seconds, settings.analysis_duration_seconds
    )
    if int(seg_lens.min()) < settings.n_fft:
        raise ValueError("Not enough samples after trimming/selection for modal cloud (need at least n_fft).")

    result = dsp.stft_db(
        settings.trim_to_peak,
        settings.ignore_leading_seconds,
        settings.analysis_duration_seconds,
        int(settings.n_fft),
        int(settings.hop_length),
        bool(settings.use_hann_window),
        float(settings.floor_db),
    )

    freq_hz = stft.rfft_freqs_hz(settings.n_fft, sample_rate_hz)
    nyquist = 0.5 * float(sample_rate_hz)
    f_min = float(np.clip(settings.f_min_hz, 1.0, nyquist))
    f_max = float(np.clip(settings.f_max_hz, f_min, nyquist))
    fmask = (freq_hz >= f_min) & (freq_hz <= f_max)
    edges = logfreq.build_log_bin_edges(f_min, f_max, int(settings.log_bins_per_octave), int(settings.min_bins))
    centres, bin_matrix_sel, nonempty = logfreq.build_log_bin_matrix(freq_hz[fmask], edges)
    bin_matrix = np.zeros((centres.size, freq_hz.size), dtype=np.float32)
    bin_matrix[:, fmask] = bin_matrix_sel

    peak, rel, frame_len = _bin_curves(
        result.mag_db, torch.from_numpy(bin_matrix).to(dsp.device), result.num_frames
    )
    # fits on the frame-hop time base
    frame_rate = float(sample_rate_hz) / float(settings.hop_length)
    metric, range_db = _metric_range(settings)
    fit = dbfit.fit_decay_slope_over_db_range(
        rel, frame_len, range_db, float(settings.fit_lower_limit_db), frame_rate,
        min_points=int(settings.min_fit_points),
    )
    peak_host, ok, rt60, r2 = fetch_packed(peak[:, :, 0], fit.ok, fit.rt60_seconds, fit.r_squared)

    reliable = (
        ok
        & nonempty[None, :]
        & ((peak_host - float(settings.floor_db)) >= float(settings.min_peak_db_above_floor))
    )
    results = []
    for i, channel_name in enumerate(dsp.channel_names):
        points = [
            ModalPoint(float(centres[b]), float(rt60[i, b]), float(r2[i, b]))
            for b in np.nonzero(reliable[i])[0]
        ]
        points.sort(key=lambda p: p.centre_hz)
        results.append(
            ChannelModalCloudResult(
                channel_name=str(channel_name),
                sample_rate_hz=int(sample_rate_hz),
                analysis_start_sample_index=int(starts[i]),
                analysis_length_samples=int(seg_lens[i]),
                metric=metric,
                points=points,
            )
        )
    return results


def analyse_modal_cloud_for_channel(
    samples: np.ndarray,
    sample_rate_hz: int,
    channel_name: str,
    settings: ModalCloudAnalysisSettings,
    device: "str | torch.device" = "cuda",
) -> ChannelModalCloudResult:
    return analyse_modal_cloud_channels(
        single_channel_dsp(samples, sample_rate_hz, channel_name, device), settings
    )[0]


def analyse_modal_cloud_from_wav_file(
    input_wav_file_path: str | Path,
    settings: Optional[ModalCloudAnalysisSettings] = None,
    dsp: Optional[FileDsp] = None,
    device: "str | torch.device" = "cuda",
) -> List[ChannelModalCloudResult]:
    if settings is None:
        settings = ModalCloudAnalysisSettings()
    if dsp is None:
        dsp = FileDsp.from_wav_file(input_wav_file_path, settings.use_mono_downmix_for_stereo, device)
    return analyse_modal_cloud_channels(dsp, settings)


def _median_curve(points: List[ModalPoint], window_octaves: float) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    if len(points) < 8:
        return None
    window_oct = float(max(0.01, window_octaves))
    freqs = np.array([p.centre_hz for p in points])
    rt60 = np.array([p.rt60_seconds for p in points])
    logf = np.log2(freqs)
    out_f, out_y = [], []
    for i in range(freqs.size):
        m = (logf >= logf[i] - 0.5 * window_oct) & (logf <= logf[i] + 0.5 * window_oct)
        if int(np.sum(m)) < 3:
            continue
        out_f.append(freqs[i])
        out_y.append(float(np.median(rt60[m])))
    if len(out_f) < 4:
        return None
    return np.array(out_f, np.float32), np.array(out_y, np.float32)


def _f_range(result: ChannelModalCloudResult, analysis_settings: ModalCloudAnalysisSettings) -> Tuple[float, float]:
    nyquist = 0.5 * float(result.sample_rate_hz)
    f_min = float(np.clip(analysis_settings.f_min_hz, 1.0, nyquist))
    return f_min, float(np.clip(analysis_settings.f_max_hz, f_min, nyquist))


def plot_modal_cloud_figure(
    result: ChannelModalCloudResult,
    analysis_settings: ModalCloudAnalysisSettings,
    plot_settings: ModalCloudPlotSettings,
    title: Optional[str] = None,
):
    from audio_analysis_tpu_torch import plot

    figure, axis = plot.create_figure_and_axis(title=title)
    axis.set_xlabel("Frequency (Hz)")
    axis.set_ylabel(f"RT60 estimate (s) [{result.metric.upper()}]")
    plot.apply_log_hz_xaxis(axis, *_f_range(result, analysis_settings))
    if not result.points:
        axis.text(0.5, 0.5, "No valid points (insufficient decay range).", transform=axis.transAxes, ha="center")
        axis.grid(True, which="both", linestyle=":", linewidth=0.5)
        return figure

    freqs = np.array([p.centre_hz for p in result.points], np.float32)
    rt60 = np.array([p.rt60_seconds for p in result.points], np.float32)
    axis.scatter(freqs, rt60, s=12, alpha=0.85, label=f"{result.channel_name} ({len(result.points)} pts)")
    if plot_settings.show_median_curve:
        med = _median_curve(result.points, plot_settings.median_octave_window)
        if med is not None:
            axis.plot(med[0], med[1], alpha=0.9, label=f"{result.channel_name} median")
    if plot_settings.ylim_seconds is not None:
        axis.set_ylim(*plot_settings.ylim_seconds)
    axis.grid(True, which="both", linestyle=":", linewidth=0.5)
    axis.legend(loc="best")
    return figure


def plot_modal_cloud_from_wav_file(
    input_wav_file_path: str | Path,
    analysis_settings: Optional[ModalCloudAnalysisSettings] = None,
    plot_settings: Optional[ModalCloudPlotSettings] = None,
    output_basename: Optional[str | Path] = None,
    show_interactive: bool = True,
    dsp: Optional[FileDsp] = None,
    device: "str | torch.device" = "cuda",
) -> List[ChannelModalCloudResult]:
    if analysis_settings is None:
        analysis_settings = ModalCloudAnalysisSettings()
    if plot_settings is None:
        plot_settings = ModalCloudPlotSettings()
    results = analyse_modal_cloud_from_wav_file(input_wav_file_path, analysis_settings, dsp=dsp, device=device)
    render_modal_cloud_plots(
        results, analysis_settings, plot_settings, output_basename, show_interactive, input_wav_file_path
    )
    return results


def render_modal_cloud_plots(
    results: List[ChannelModalCloudResult],
    analysis_settings: ModalCloudAnalysisSettings,
    plot_settings: ModalCloudPlotSettings,
    output_basename: Optional[str | Path],
    show_interactive: bool,
    title_source: str | Path,
) -> None:
    """Figures and save only (host matplotlib); results come from
    analyse_*. Saved figures with points go through a live template that
    mirrors plot_modal_cloud_figure."""
    from audio_analysis_tpu_torch import plot

    for r in results:
        title = f"Modal cloud — {title_source} — {r.channel_name}"
        output_path = None if output_basename is None else suffixed_png(output_basename, f"_modalcloud_{r.channel_name}")
        med = (
            _median_curve(r.points, plot_settings.median_octave_window)
            if (plot_settings.show_median_curve and r.points)
            else None
        )
        if output_path is None or show_interactive or not r.points:
            # an empty cloud draws a text panel: another artist structure
            fig = plot_modal_cloud_figure(r, analysis_settings, plot_settings, title)
            plot.finalize_and_show_or_save(fig, output_path, show_interactive)
            continue

        def build(r=r, title=title):
            fig = plot_modal_cloud_figure(r, analysis_settings, plot_settings, title)
            axis = fig.axes[0]
            return fig, {"axis": axis, "scatter": axis.collections[0], "median": axis.lines[0] if axis.lines else None}

        def update(fig, state, r=r, med=med, title=title):
            _update_modal_cloud_figure(fig, state, r, med, analysis_settings, plot_settings, title)

        plot.save_via_template(
            kind="modal_cloud",
            key=(analysis_settings, plot_settings, int(r.sample_rate_hz), r.metric, med is not None),
            build=build,
            update=update,
            output_path=output_path,
        )


def _update_modal_cloud_figure(
    figure,
    state: dict,
    result: ChannelModalCloudResult,
    med,
    analysis_settings: ModalCloudAnalysisSettings,
    plot_settings: ModalCloudPlotSettings,
    title: str,
) -> None:
    """Re-apply the data-dependent artists of plot_modal_cloud_figure to a
    live template figure (points present, the median curve as keyed)."""
    import matplotlib.transforms as mtransforms

    from audio_analysis_tpu_torch import plot

    axis = state["axis"]
    freqs = np.array([p.centre_hz for p in result.points], np.float32)
    rt60 = np.array([p.rt60_seconds for p in result.points], np.float32)
    pts = np.column_stack([freqs, rt60])
    scatter = state["scatter"]
    scatter.set_offsets(pts)
    scatter.set_label(f"{result.channel_name} ({len(result.points)} pts)")
    if med is not None:
        if state["median"] is None:
            raise RuntimeError("median line missing")  # -> rebuild fresh
        state["median"].set_data(med[0], med[1])
        state["median"].set_label(f"{result.channel_name} median")
    # the fresh figure's autoscale: dataLim = the points and the median
    # curve (relim() ignores collections, so the limits are rebuilt here)
    axis.dataLim = mtransforms.Bbox.null()
    axis.dataLim.update_from_data_xy(pts, ignore=True)
    if med is not None:
        axis.dataLim.update_from_data_xy(np.column_stack([med[0], med[1]]), ignore=False)
    axis.autoscale(True)
    axis.autoscale_view()
    plot.apply_log_hz_xaxis(axis, *_f_range(result, analysis_settings))
    if plot_settings.ylim_seconds is not None:
        axis.set_ylim(*plot_settings.ylim_seconds)
    axis.legend(loc="best")
    axis.set_title(title)


def summarise_modal_cloud_results_text(results: List[ChannelModalCloudResult]) -> str:
    lines = []
    for r in results:
        dur = float(r.analysis_length_samples) / float(r.sample_rate_hz)
        lines.append(
            f"[{r.channel_name}] metric={r.metric} "
            f"start_sample={r.analysis_start_sample_index} dur={dur:.3f}s points={len(r.points)}"
        )
        if r.points:
            rt = np.array([p.rt60_seconds for p in r.points])
            lines.append(
                f"  rt60: median={np.median(rt):.3f}s  "
                f"p90={np.percentile(rt, 90):.3f}s  max={np.max(rt):.3f}s"
            )
    return "\n".join(lines)
