"""
Z-plane poles (and optional FIR zeros) from an AR (all-pole) fit of an IR
segment (audio_analysis_tpu/analyses/zplane.py): covariance-method least
squares with an optional ridge, poles from the companion polynomial,
approximate zeros from the AR-filtered segment, the summary, and one
pole-cloud figure per channel `<basename>_zplane_<CH>.png` with the
RT60-from-pole-radius annotation.

The Gram accumulation over up to ~10^6 rows runs on the device as batched
float32 products (ops.spectral.ar_normal_equations), every channel at
once; the (p, p) float64 solve and the root finding run on the host.
matplotlib is imported by the figure functions only.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from audio_analysis_tpu_torch.analyses._common import FileDsp, fetch_packed, single_channel_dsp, suffixed_png
from audio_analysis_tpu_torch.ops import spectral
from audio_analysis_tpu_torch.ops.common import bool_valid_mask


@dataclass(frozen=True)
class ZPlaneAnalysisSettings:
    use_mono_downmix_for_stereo: bool = False
    trim_to_peak: bool = True
    ignore_leading_seconds: float = 0.0
    analysis_duration_seconds: Optional[float] = None
    model: str = "ar"
    ar_order: int = 256
    derive_zeros: bool = False
    zero_order: int = 64
    normalise_segment: bool = True
    ridge_lambda: float = 0.0


@dataclass(frozen=True)
class ZPlanePlotSettings:
    secondary_channel_alpha: float = 0.7
    show_unit_circle: bool = True
    show_axes: bool = True
    limit_radius: float = 1.2
    annotate_stats: bool = True


@dataclass(frozen=True)
class ChannelZPlaneResult:
    channel_name: str
    sample_rate_hz: int
    poles: np.ndarray  # complex
    zeros: Optional[np.ndarray]  # complex or None


def rt60_from_pole_radius(radius: float, sample_rate_hz: int) -> float:
    """RT60 ~= ln(1000) * tau with tau_samples = -1/ln(r)."""
    radius = float(radius)
    if radius <= 0.0 or radius >= 1.0:
        return float("inf")
    tau_seconds = (-1.0 / np.log(radius)) / float(sample_rate_hz)
    return float(np.log(1000.0) * tau_seconds)


def fit_ar_channels(dsp: FileDsp, settings: ZPlaneAnalysisSettings) -> List[np.ndarray]:
    """Each channel's AR coefficients (a[0] = 1) of its trimmed and, with
    `normalise_segment`, peak-normalised segment: every channel's Gram in
    one batched float32 device pass, the float64 solves on the host. The
    order drops to one less than the shortest segment where that is
    shorter than `ar_order`."""
    trim_key = (settings.trim_to_peak, settings.ignore_leading_seconds, settings.analysis_duration_seconds)
    aligned = dsp.aligned(*trim_key)
    _, seg_lens = dsp.aligned_host_meta(*trim_key)

    order = int(settings.ar_order)
    min_seg = int(seg_lens.min())
    if min_seg <= order:
        order = max(1, min_seg - 1)

    # per-channel peak normalisation: a float32 division of float32 values
    # is correctly rounded, so this equals the float64 division cast back
    seg = aligned.samples
    if settings.normalise_segment:
        peak = torch.where(bool_valid_mask(seg.shape[-1], aligned.length), seg.abs(), 0.0).amax(dim=-1)
        seg = torch.where(peak[:, None] > 0.0, seg / torch.where(peak > 0.0, peak, 1.0)[:, None], seg)

    normal = spectral.ar_normal_equations(seg, aligned.length, order)
    grams, moments = fetch_packed(normal.gram, normal.moment)
    return [
        spectral.solve_ar_coefficients(grams[i], moments[i], float(settings.ridge_lambda))
        for i in range(dsp.num_channels)
    ]


def host_segments(dsp: FileDsp, settings: ZPlaneAnalysisSettings) -> List[np.ndarray]:
    """Each channel's trimmed segment in float64 on the host, divided by
    its peak with `normalise_segment`."""
    trim_key = (settings.trim_to_peak, settings.ignore_leading_seconds, settings.analysis_duration_seconds)
    _, seg_lens = dsp.aligned_host_meta(*trim_key)
    host = dsp.aligned(*trim_key).samples.cpu().numpy()
    segments = []
    for i in range(dsp.num_channels):
        s = host[i][: int(seg_lens[i])].astype(np.float64)
        if settings.normalise_segment and s.size:
            peak64 = float(np.max(np.abs(s)))
            if peak64 > 0.0:
                s = s / peak64
        segments.append(s)
    return segments


def analyse_zplane_channels(
    dsp: FileDsp,
    settings: ZPlaneAnalysisSettings,
) -> List[ChannelZPlaneResult]:
    """All channels' Gram accumulations in one batched device pass; the
    solves and the roots on the host, per channel."""
    coefficients = fit_ar_channels(dsp, settings)
    # the zeros use the float64 normalised segment, as the JAX package does
    segs64 = host_segments(dsp, settings) if settings.derive_zeros else []

    results = []
    for i, channel_name in enumerate(dsp.channel_names):
        a = coefficients[i]
        zeros: Optional[np.ndarray] = None
        if settings.derive_zeros:
            b = spectral.derive_fir_numerator_from_ar(a, segs64[i], int(settings.zero_order))
            zeros = spectral.ar_poles(b)
        results.append(
            ChannelZPlaneResult(
                channel_name=channel_name,
                sample_rate_hz=int(dsp.sample_rate_hz),
                poles=spectral.ar_poles(a),
                zeros=zeros,
            )
        )
    return results


def analyse_zplane_for_channel(
    samples: np.ndarray,
    sample_rate_hz: int,
    channel_name: str,
    settings: ZPlaneAnalysisSettings,
    device: "str | torch.device" = "cuda",
) -> ChannelZPlaneResult:
    return analyse_zplane_channels(single_channel_dsp(samples, sample_rate_hz, channel_name, device), settings)[0]


def analyse_zplane_from_wav_file(
    input_wav_file_path: str | Path,
    settings: Optional[ZPlaneAnalysisSettings] = None,
    dsp: Optional[FileDsp] = None,
    device: "str | torch.device" = "cuda",
) -> List[ChannelZPlaneResult]:
    if settings is None:
        settings = ZPlaneAnalysisSettings()
    if dsp is None:
        dsp = FileDsp.from_wav_file(input_wav_file_path, settings.use_mono_downmix_for_stereo, device)
    return analyse_zplane_channels(dsp, settings)


def render_zplane_plots(
    results: List[ChannelZPlaneResult],
    settings: ZPlaneAnalysisSettings,
    plot_settings: ZPlanePlotSettings,
    output_basename: Optional[str | Path],
    show_interactive: bool,
) -> None:
    """One pole (and zero) cloud per channel with the unit circle and the
    radius statistics; host matplotlib."""
    from audio_analysis_tpu_torch import plot

    for result in results:
        fig, ax = plot.create_figure_and_axis(
            title=f"Z-plane pole cloud ({result.channel_name})", figure_size=(7.5, 7.5)
        )
        if plot_settings.show_axes:
            ax.axhline(0.0, linewidth=1.0)
            ax.axvline(0.0, linewidth=1.0)
        if plot_settings.show_unit_circle:
            t = np.linspace(0.0, 2.0 * np.pi, 512)
            ax.plot(np.cos(t), np.sin(t), linestyle="--", linewidth=1.0)
        poles = result.poles
        if poles.size:
            ax.scatter(np.real(poles), np.imag(poles), marker="x", s=30, label="Poles")
        if result.zeros is not None and result.zeros.size:
            ax.scatter(
                np.real(result.zeros), np.imag(result.zeros), marker="o", s=18, facecolors="none", label="Zeros"
            )
        ax.set_aspect("equal", adjustable="box")
        lim = float(plot_settings.limit_radius)
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)
        ax.set_xlabel("Re{z}")
        ax.set_ylabel("Im{z}")
        ax.legend(loc="upper right")
        if plot_settings.annotate_stats and poles.size:
            radii = np.abs(poles)
            med_r, max_r = float(np.median(radii)), float(np.max(radii))
            rt60_med = rt60_from_pole_radius(min(med_r, 0.999999), result.sample_rate_hz)
            rt60_max = rt60_from_pole_radius(min(max_r, 0.999999), result.sample_rate_hz)
            ax.text(
                0.02,
                0.02,
                (
                    f"AR order: {int(settings.ar_order)}\n"
                    f"poles: {poles.size}\n"
                    f"unstable (|p|>=1): {int(np.sum(radii >= 1.0))}\n"
                    f"radius median: {med_r:.6f}\n"
                    f"radius max: {max_r:.6f}\n"
                    f"RT60~ (median r): {rt60_med:.3f} s\n"
                    f"RT60~ (max r): {rt60_max:.3f} s"
                ),
                transform=ax.transAxes,
                fontsize=9,
                va="bottom",
                ha="left",
            )
        output_path = None if output_basename is None else suffixed_png(output_basename, f"_zplane_{result.channel_name}")
        plot.finalize_and_show_or_save(fig, output_path, show_interactive)


def plot_zplane_from_wav_file(
    input_wav_file_path: str | Path,
    settings: Optional[ZPlaneAnalysisSettings] = None,
    plot_settings: Optional[ZPlanePlotSettings] = None,
    output_basename: Optional[str | Path] = None,
    show_interactive: bool = True,
    dsp: Optional[FileDsp] = None,
    device: "str | torch.device" = "cuda",
) -> List[ChannelZPlaneResult]:
    if settings is None:
        settings = ZPlaneAnalysisSettings()
    if plot_settings is None:
        plot_settings = ZPlanePlotSettings()
    results = analyse_zplane_from_wav_file(input_wav_file_path, settings, dsp=dsp, device=device)
    render_zplane_plots(results, settings, plot_settings, output_basename, show_interactive)
    return results


def summarise_zplane_results_text(results: List[ChannelZPlaneResult]) -> str:
    lines: List[str] = []
    for r in results:
        if r.poles.size == 0:
            lines.append(f"- {r.channel_name}: no poles (fit failed or order=0)")
            continue
        radii = np.abs(r.poles)
        lines.append(
            f"- {r.channel_name}: poles={r.poles.size}, "
            f"max|p|={float(np.max(radii)):.6f}, median|p|={float(np.median(radii)):.6f}, "
            f"unstable(|p|>=1)={int(np.sum(radii >= 1.0))}"
        )
    if not lines:
        return "No z-plane results."
    return "Z-plane summary:\n" + "\n".join(lines)
