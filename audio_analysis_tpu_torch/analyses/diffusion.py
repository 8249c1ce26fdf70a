"""
Diffusion / decorrelation over time (audio_analysis_tpu/analyses/
diffusion.py): per window the max |autocorrelation| and the echo density,
and for a stereo file corr0 and IACC on L/R aligned at the peak of the
(L+R)/2 downmix, with the per-metric median summary and the one combined
figure `<basename>_diffusion.png`.

Every window and lag comes from batched torch.fft correlations
(ops.diffusion). matplotlib is imported by the figure function only.
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
    pad_to_bucket,
    single_channel_dsp,
    suffixed_png,
)
from audio_analysis_tpu_torch.ops import diffusion as dops
from audio_analysis_tpu_torch.ops import trim


@dataclass(frozen=True)
class DiffusionAnalysisSettings:
    use_mono_downmix_for_stereo: bool = False
    trim_to_peak: bool = True
    ignore_leading_seconds: float = 0.0
    window_seconds: float = 0.050
    hop_seconds: float = 0.010
    max_lag_milliseconds: float = 10.0
    echo_density_threshold_rms: float = 1.0
    echo_density_normalise_to_gaussian: bool = True


@dataclass(frozen=True)
class DiffusionTimeSeries:
    time_seconds: np.ndarray
    max_abs_autocorr: np.ndarray
    echo_density: np.ndarray
    corr0: Optional[np.ndarray] = None
    iacc_max: Optional[np.ndarray] = None


@dataclass(frozen=True)
class DiffusionChannelResult:
    channel_name: str
    sample_rate_hz: int
    series: DiffusionTimeSeries


def _window_params(settings: DiffusionAnalysisSettings, sample_rate_hz: int):
    win = max(16, int(round(settings.window_seconds * sample_rate_hz)))
    hop = max(1, int(round(settings.hop_seconds * sample_rate_hz)))
    max_lag = max(1, int(round(settings.max_lag_milliseconds / 1000.0 * sample_rate_hz)))
    return win, hop, max_lag


def analyse_diffusion_channels(
    dsp: FileDsp,
    settings: DiffusionAnalysisSettings,
) -> List[DiffusionChannelResult]:
    """Per-channel diffusion metrics for all channels in one batched pass."""
    sample_rate_hz = dsp.sample_rate_hz
    win, hop, max_lag = _window_params(settings, sample_rate_hz)
    aligned = dsp.aligned(settings.trim_to_peak, settings.ignore_leading_seconds)
    _, seg_lens = dsp.aligned_host_meta(settings.trim_to_peak, settings.ignore_leading_seconds)
    if int(seg_lens.min()) < win:
        raise ValueError("Not enough samples for diffusion analysis windows.")

    r = dops.diffusion_metrics(
        aligned.samples,
        aligned.length,
        win,
        hop,
        max_lag,
        sample_rate_hz,
        float(settings.echo_density_threshold_rms),
        bool(settings.echo_density_normalise_to_gaussian),
    )
    time_seconds, autocorr, echo, num_frames = fetch_packed(*r)
    results = []
    for i, channel_name in enumerate(dsp.channel_names):
        t_valid = int(num_frames[i])
        series = DiffusionTimeSeries(
            time_seconds=time_seconds[:t_valid].astype(np.float32),
            max_abs_autocorr=autocorr[i][:t_valid].astype(np.float32),
            echo_density=echo[i][:t_valid].astype(np.float32),
        )
        results.append(DiffusionChannelResult(channel_name, int(sample_rate_hz), series))
    return results


def analyse_diffusion_for_channel(
    samples: np.ndarray,
    sample_rate_hz: int,
    channel_name: str,
    settings: DiffusionAnalysisSettings,
    device: "str | torch.device" = "cuda",
) -> DiffusionChannelResult:
    return analyse_diffusion_channels(
        single_channel_dsp(samples, sample_rate_hz, channel_name, device), settings
    )[0]


def analyse_diffusion_from_wav_file(
    input_wav_file_path: str | Path,
    settings: Optional[DiffusionAnalysisSettings] = None,
    dsp: Optional[FileDsp] = None,
    device: "str | torch.device" = "cuda",
) -> List[DiffusionChannelResult]:
    if settings is None:
        settings = DiffusionAnalysisSettings()
    if dsp is None:
        dsp = FileDsp.from_wav_file(input_wav_file_path, settings.use_mono_downmix_for_stereo, device)

    sr = dsp.sample_rate_hz
    results = analyse_diffusion_channels(dsp, settings)
    if settings.use_mono_downmix_for_stereo or dsp.num_channels != 2:
        return results

    # true stereo: corr0 / IACC once, on L/R aligned at the peak of the
    # (L+R)/2 downmix, the same series attached to both channels
    win, hop, max_lag = _window_params(settings, sr)
    left_raw, right_raw = dsp.host_channels
    combined = (0.5 * (left_raw.astype(np.float64) + right_raw.astype(np.float64))).astype(np.float32)
    c, length = pad_to_bucket(combined, dsp.device)
    c_aligned = trim.align_for_analysis(c, length, sr, settings.trim_to_peak, settings.ignore_leading_seconds)
    start, seg_len = (int(v[0]) for v in fetch_packed(c_aligned.start_index, c_aligned.length))

    # the L/R rows are already on the device in the FileDsp batch
    edges = torch.tensor([start, start], dtype=torch.int32, device=dsp.device)
    lr_al = trim.shift_to(dsp.x, edges, edges + seg_len)
    s = dops.stereo_diffusion_metrics_rows(lr_al.samples, lr_al.length, win, hop, max_lag)
    corr0_dev, iacc_dev = fetch_packed(s.corr0, s.iacc_max)
    t_valid = results[0].series.time_seconds.size
    t_stereo = 0 if seg_len < win else 1 + (seg_len - win) // hop

    def _fit_to_timeline(arr: np.ndarray) -> np.ndarray:
        out = np.full(t_valid, np.nan, dtype=np.float32)
        take = min(t_valid, t_stereo)
        out[:take] = arr[:take]
        return out

    corr0 = _fit_to_timeline(corr0_dev[0])
    iacc = _fit_to_timeline(iacc_dev[0])
    return [
        DiffusionChannelResult(
            res.channel_name,
            res.sample_rate_hz,
            DiffusionTimeSeries(
                time_seconds=res.series.time_seconds,
                max_abs_autocorr=res.series.max_abs_autocorr,
                echo_density=res.series.echo_density,
                corr0=corr0,
                iacc_max=iacc,
            ),
        )
        for res in results
    ]


def render_diffusion_plots(
    results: List[DiffusionChannelResult],
    output_basename: Optional[str | Path],
    show_interactive: bool,
    title_source: str | Path,
) -> None:
    """Figure and save only (host matplotlib), through the line-figure
    template; results come from analyse_*."""
    from audio_analysis_tpu_torch import plot

    lines = []
    for ch_i, r in enumerate(results):
        alpha = 1.0 if ch_i == 0 else 0.7
        lines.append(
            (r.series.time_seconds, r.series.max_abs_autocorr, {"alpha": alpha, "label": f"max|autocorr| {r.channel_name}"})
        )
        lines.append(
            (
                r.series.time_seconds,
                r.series.echo_density,
                {"alpha": alpha, "linestyle": "--", "label": f"echo_density {r.channel_name}"},
            )
        )
    if results and results[0].series.corr0 is not None and results[0].series.iacc_max is not None:
        series = results[0].series
        lines.append((series.time_seconds, series.corr0, {"linestyle": ":", "label": "corr0 (L,R)"}))
        lines.append((series.time_seconds, series.iacc_max, {"linestyle": "-.", "label": "IACC max (±lag)"}))

    def setup(axis):
        plot.label_time_axis_seconds(axis)
        axis.set_ylabel("Metric (unitless)")
        axis.set_ylim(-0.05, 1.25)
        axis.grid(True, which="both", linestyle=":", linewidth=0.5)

    output_path = None if output_basename is None else suffixed_png(output_basename, "_diffusion")
    plot.render_line_figure(
        "diffusion",
        (tuple(r.channel_name for r in results),),
        f"Diffusion — {title_source}",
        lines,
        output_path,
        show_interactive,
        legend_kwargs={"loc": "best"},
        setup=setup,
    )


def plot_diffusion_from_wav_file(
    input_wav_file_path: str | Path,
    analysis_settings: Optional[DiffusionAnalysisSettings] = None,
    output_basename: Optional[str | Path] = None,
    show_interactive: bool = True,
    dsp: Optional[FileDsp] = None,
    device: "str | torch.device" = "cuda",
) -> List[DiffusionChannelResult]:
    if analysis_settings is None:
        analysis_settings = DiffusionAnalysisSettings()
    results = analyse_diffusion_from_wav_file(input_wav_file_path, analysis_settings, dsp=dsp, device=device)
    render_diffusion_plots(results, output_basename, show_interactive, input_wav_file_path)
    return results


def summarise_diffusion_results_text(results: List[DiffusionChannelResult]) -> str:
    lines: List[str] = []
    for r in results:
        lines.append(f"[{r.channel_name}]")
        lines.append(f"  median_max_abs_autocorr={float(np.nanmedian(r.series.max_abs_autocorr)):.3f}")
        lines.append(f"  median_echo_density={float(np.nanmedian(r.series.echo_density)):.3f}")
        if r.series.corr0 is not None and r.series.iacc_max is not None:
            lines.append(f"  median_corr0={float(np.nanmedian(r.series.corr0)):.3f}")
            lines.append(f"  median_iacc_max={float(np.nanmedian(r.series.iacc_max)):.3f}")
    return "\n".join(lines)
