"""
Band-limited RT60 through the FFT-mask filterbank
(audio_analysis_tpu/analyses/rt60bands.py): band modes "three" | "octave"
| "third", raised-cosine masks, the full-band trim shared by every band,
the tabular summary, and the figure `<basename>_rt60bands.png` (grouped
bars up to 6 bands, else lines over the band centres).

The full signal is filtered (the padded-bucket filtering with no circular
wrap that the JAX package documents in docs/MIGRATION.md), every band is
shifted by its channel's full-band start, and the EDC of every (channel,
band) is one call of kernel K1. matplotlib is imported by the figure
functions only.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from audio_analysis_tpu_torch.analyses._common import FileDsp, fetch_packed, single_channel_dsp, suffixed_png
from audio_analysis_tpu_torch.analyses.decay import DecayAnalysisSettings
from audio_analysis_tpu_torch.ops import dbfit, edc, fftmask, trim
from audio_analysis_tpu_torch.ops.fftmask import BandDefinition


@dataclass(frozen=True)
class Rt60BandsAnalysisSettings:
    band_mode: str = "three"  # "three" | "octave" | "third"
    low_upper_hz: float = 250.0
    mid_center_hz: float = 1000.0
    mid_width_octaves: float = 2.0
    high_lower_hz: float = 4000.0
    f_min_hz: float = 31.5
    f_max_hz: float = 16000.0
    transition_width_octaves: float = 1.0 / 6.0
    include_t20: bool = False
    include_edt: bool = False
    decay_settings: DecayAnalysisSettings = field(default_factory=DecayAnalysisSettings)


@dataclass(frozen=True)
class Rt60BandsPlotSettings:
    ylim_seconds: Optional[Tuple[float, float]] = None
    secondary_channel_alpha: float = 0.7
    legend_values: bool = True


@dataclass(frozen=True)
class Rt60BandMetrics:
    rt60_t30_seconds: Optional[float]
    rt60_t20_seconds: Optional[float]
    edt_seconds: Optional[float]


@dataclass(frozen=True)
class Rt60BandsChannelResult:
    channel_name: str
    sample_rate_hz: int
    band_definitions: List[BandDefinition]
    band_metrics_by_name: Dict[str, Rt60BandMetrics]


def build_band_definitions(settings: Rt60BandsAnalysisSettings, sample_rate_hz: int) -> List[BandDefinition]:
    mode = str(settings.band_mode).lower()
    if mode == "three":
        return fftmask.build_three_band_definitions(
            sample_rate_hz,
            settings.low_upper_hz,
            settings.mid_center_hz,
            settings.mid_width_octaves,
            settings.high_lower_hz,
        )
    if mode == "octave":
        return fftmask.build_fractional_octave_band_definitions(
            sample_rate_hz, 1, settings.f_min_hz, settings.f_max_hz
        )
    if mode == "third":
        return fftmask.build_fractional_octave_band_definitions(
            sample_rate_hz, 3, settings.f_min_hz, settings.f_max_hz
        )
    raise ValueError(f"Unknown band_mode: {settings.band_mode}")


def analyse_rt60_bands_channels(
    dsp: FileDsp,
    settings: Rt60BandsAnalysisSettings,
) -> List[Rt60BandsChannelResult]:
    """Every (channel, band) EDC in one K1 launch, every fit batched."""
    if min(c.shape[-1] for c in dsp.host_channels) < 8:
        raise ValueError("Not enough samples for rt60bands analysis.")

    sample_rate_hz = dsp.sample_rate_hz
    ds = settings.decay_settings
    x, length = dsp.x, dsp.lengths  # (C, N_pad), (C,)

    bands = build_band_definitions(settings, sample_rate_hz)
    masks = fftmask.build_band_mask_matrix(
        bands, dsp.bucket_samples, sample_rate_hz, settings.transition_width_octaves
    )
    banded = fftmask.apply_band_masks(x, torch.from_numpy(masks).to(x.device))  # (C, bands, N)

    # the full-band trim, shared by every band of a channel
    if ds.trim_to_peak:
        start = trim.peak_index(x, length)
    else:
        start = torch.zeros_like(length)
    ignore = int(round(ds.ignore_leading_seconds * sample_rate_hz))
    if ignore > 0:
        start = torch.minimum(start + ignore, length)
    aligned = trim.shift_bands_to(banded, start, length)

    curve = edc.schroeder_edc_db(
        aligned.samples,
        aligned.length,
        edc_epsilon=ds.edc_epsilon,
        edc_floor_db=ds.edc_floor_db,
        smoothing_window_samples=ds.edc_smoothing_window_samples,
    )

    ranges = {"t30": ds.t30_range_db}
    if settings.include_t20:
        ranges["t20"] = ds.t20_range_db
    if settings.include_edt:
        ranges["edt"] = ds.edt_range_db
    fits = [
        dbfit.fit_decay_slope_over_db_range(
            curve.edc_db, curve.length, range_db, ds.fit_lower_limit_db, sample_rate_hz
        )
        for range_db in ranges.values()
    ]
    # one copy for every fit plane and the aligned lengths
    host = fetch_packed(aligned.length, *[t for fit in fits for t in (fit.rt60_seconds, fit.ok)])
    seg_len = host[0]
    rt60 = {key: np.where(host[2 + 2 * k], host[1 + 2 * k], np.nan) for k, key in enumerate(ranges)}

    def pick(key: str, c: int, i: int) -> Optional[float]:
        value = rt60.get(key)
        if value is None or not np.isfinite(value[c, i]):
            return None
        return float(value[c, i])

    results = []
    for c, channel_name in enumerate(dsp.channel_names):
        metrics: Dict[str, Rt60BandMetrics] = {}
        for i, band in enumerate(bands):
            if int(seg_len[c, i]) < 8:
                metrics[band.name] = Rt60BandMetrics(None, None, None)
                continue
            metrics[band.name] = Rt60BandMetrics(pick("t30", c, i), pick("t20", c, i), pick("edt", c, i))
        results.append(
            Rt60BandsChannelResult(
                channel_name=channel_name,
                sample_rate_hz=int(sample_rate_hz),
                band_definitions=bands,
                band_metrics_by_name=metrics,
            )
        )
    return results


def analyse_rt60_bands_for_channel(
    samples: np.ndarray,
    sample_rate_hz: int,
    channel_name: str,
    settings: Rt60BandsAnalysisSettings,
    device: "str | torch.device" = "cuda",
) -> Rt60BandsChannelResult:
    samples = np.asarray(samples)
    if samples.size < 8:
        raise ValueError("Not enough samples for rt60bands analysis.")
    return analyse_rt60_bands_channels(
        single_channel_dsp(samples, sample_rate_hz, channel_name, device), settings
    )[0]


def analyse_rt60_bands_from_wav_file(
    input_wav_file_path: str | Path,
    settings: Optional[Rt60BandsAnalysisSettings] = None,
    dsp: Optional[FileDsp] = None,
    device: "str | torch.device" = "cuda",
) -> List[Rt60BandsChannelResult]:
    if settings is None:
        settings = Rt60BandsAnalysisSettings()
    if dsp is None:
        dsp = FileDsp.from_wav_file(
            input_wav_file_path, settings.decay_settings.use_mono_downmix_for_stereo, device
        )
    return analyse_rt60_bands_channels(dsp, settings)


def _metric_value(m: Rt60BandMetrics, metric: str) -> Optional[float]:
    if metric == "T30":
        return m.rt60_t30_seconds
    if metric == "T20":
        return m.rt60_t20_seconds
    if metric == "EDT":
        return m.edt_seconds
    raise ValueError(metric)


def plot_rt60_bands_figure(
    channel_results: List[Rt60BandsChannelResult],
    settings: Rt60BandsAnalysisSettings,
    plot_settings: Rt60BandsPlotSettings,
    title: Optional[str] = None,
):
    """<= 6 bands: grouped bars; else a log-x line plot over the band centres."""
    from audio_analysis_tpu_torch import plot

    if not channel_results:
        raise ValueError("No channel results to plot.")
    bands = channel_results[0].band_definitions
    band_names = [b.name for b in bands]
    centres_hz = np.array([b.centre_hz for b in bands], np.float32)
    metrics = ["T30"] + (["T20"] if settings.include_t20 else []) + (["EDT"] if settings.include_edt else [])

    figure, axis = plot.create_figure_and_axis(title=title)

    def values_of(channel: Rt60BandsChannelResult, metric: str) -> List[Optional[float]]:
        return [
            _metric_value(channel.band_metrics_by_name[b], metric) if b in channel.band_metrics_by_name else None
            for b in band_names
        ]

    def label_for(metric: str, channel: Rt60BandsChannelResult, values: List[Optional[float]]) -> str:
        if plot_settings.legend_values:
            parts = [f"{band}={'NA' if v is None else f'{v:.2f}s'}" for band, v in zip(band_names, values)]
            return f"{metric} {channel.channel_name}  " + "  ".join(parts)
        return f"{metric} {channel.channel_name}"

    if len(bands) <= 6:
        axis.set_xlabel("Band")
        axis.set_ylabel("RT60 (seconds)")
        x = np.arange(len(bands), dtype=np.float32)
        axis.set_xticks(x)
        axis.set_xticklabels(band_names)
        total_groups = len(metrics) * len(channel_results)
        bar_width = 0.8 / max(1, total_groups)
        offset_index = 0
        for ch_i, channel in enumerate(channel_results):
            alpha = 1.0 if ch_i == 0 else float(plot_settings.secondary_channel_alpha)
            for metric in metrics:
                values = values_of(channel, metric)
                axis.bar(
                    x + (offset_index - total_groups / 2) * bar_width + bar_width / 2,
                    [np.nan if v is None else v for v in values],
                    width=bar_width,
                    alpha=alpha,
                    label=label_for(metric, channel, values),
                )
                offset_index += 1
        axis.grid(True, axis="y", linestyle=":", linewidth=0.5)
    else:
        axis.set_xlabel("Band centre frequency (Hz)")
        axis.set_ylabel("RT60 (seconds)")
        axis.set_xscale("log")
        axis.grid(True, which="both", linestyle=":", linewidth=0.5)
        linestyle = {"T30": "-", "T20": "--", "EDT": ":"}
        for ch_i, channel in enumerate(channel_results):
            alpha = 1.0 if ch_i == 0 else float(plot_settings.secondary_channel_alpha)
            for metric in metrics:
                values = values_of(channel, metric)
                axis.plot(
                    centres_hz,
                    np.array([np.nan if v is None else v for v in values], np.float32),
                    linestyle=linestyle[metric],
                    marker="o",
                    alpha=alpha,
                    label=label_for(metric, channel, values),
                )

    if plot_settings.ylim_seconds is not None:
        axis.set_ylim(*plot_settings.ylim_seconds)
    axis.legend(loc="best")
    return figure


def render_rt60_bands_plots(
    results: List[Rt60BandsChannelResult],
    settings: Rt60BandsAnalysisSettings,
    plot_settings: Rt60BandsPlotSettings,
    output_basename: Optional[str | Path],
    show_interactive: bool,
    title_source: str | Path,
) -> None:
    """Figure and save only (host matplotlib); results come from analyse_*."""
    from audio_analysis_tpu_torch import plot

    # numeric legends are only readable for the 3-band mode
    if plot_settings.legend_values and str(settings.band_mode).lower() in ("octave", "third"):
        plot_settings = dataclasses.replace(plot_settings, legend_values=False)
    figure = plot_rt60_bands_figure(results, settings, plot_settings, title=f"RT60 bands — {title_source}")
    output_path = None if output_basename is None else suffixed_png(output_basename, "_rt60bands")
    plot.finalize_and_show_or_save(figure, output_path, show_interactive)


def plot_rt60_bands_from_wav_file(
    input_wav_file_path: str | Path,
    settings: Optional[Rt60BandsAnalysisSettings] = None,
    plot_settings: Optional[Rt60BandsPlotSettings] = None,
    output_basename: Optional[str | Path] = None,
    show_interactive: bool = True,
    dsp: Optional[FileDsp] = None,
    device: "str | torch.device" = "cuda",
) -> List[Rt60BandsChannelResult]:
    if settings is None:
        settings = Rt60BandsAnalysisSettings()
    if plot_settings is None:
        plot_settings = Rt60BandsPlotSettings()
    results = analyse_rt60_bands_from_wav_file(input_wav_file_path, settings, dsp=dsp, device=device)
    render_rt60_bands_plots(results, settings, plot_settings, output_basename, show_interactive, input_wav_file_path)
    return results


def summarise_rt60_bands_results_text(
    channel_results: List[Rt60BandsChannelResult],
    include_t20: bool,
    include_edt: bool,
) -> str:
    lines: List[str] = []
    metrics = ["T30"] + (["T20"] if include_t20 else []) + (["EDT"] if include_edt else [])
    for channel in channel_results:
        lines.append(f"[{channel.channel_name}]")
        lines.append("  ".join(["Band"] + [f"{m}_RT60(s)" for m in metrics]))
        for band in channel.band_definitions:
            bm = channel.band_metrics_by_name.get(band.name)
            row = [band.name]
            for m in metrics:
                v = None if bm is None else _metric_value(bm, m)
                row.append("NA" if v is None else f"{float(v):.3f}")
            lines.append("  ".join(row))
        lines.append("")
    return "\n".join(lines)
