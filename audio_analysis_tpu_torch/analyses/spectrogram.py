"""
Spectrogram (time-frequency magnitude) analysis, summary and figure
(audio_analysis_tpu/analyses/spectrogram.py): n_fft 4096, hop 512, Hann,
floor -120 dB, valid framing; a log-frequency image (default) or the
reference's per-bin QuadMesh, the colour ceiling at the 99.5th percentile
minus the dynamic range, one PNG per channel
`<basename>_spectrogram_<CH>.png`.

The dB plane of every channel is one call of kernel K2 (ops.stft) through
the file's memoised STFT. The summary and the per-file API fetch it in the
1/128-dB fixed point; the report keeps it on the device and fetches only
the display-resolution image and the colour percentiles
(`analyse_spectrogram_display`, ops.display.pooled_log_freq_image).
matplotlib is imported by the figure functions only.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from audio_analysis_tpu_torch.analyses._common import FileDsp, single_channel_dsp, suffixed_png
from audio_analysis_tpu_torch.ops import display, stft


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
class SpectrogramPlotSettings:
    vmin_db: Optional[float] = None
    vmax_db: Optional[float] = None
    # "image": a log-frequency raster of display resolution (default);
    # "quadmesh": the reference's exact per-bin QuadMesh
    renderer: str = "image"
    image_rows: int = 720


@dataclass(frozen=True)
class SpectrogramDisplayData:
    """The display-resolution products fetched from the device
    (ops.display): the log-frequency max-pooled image and the colour
    percentiles of the full-resolution valid region."""

    image: np.ndarray  # (rows, T') dB, low->high frequency rows
    p995_db: float
    p5_db: float
    n_fft: int
    num_frames: int


@dataclass(frozen=True)
class ChannelSpectrogramResult:
    channel_name: str
    sample_rate_hz: int
    analysis_start_sample_index: int
    analysis_length_samples: int
    time_seconds: np.ndarray  # (T,)
    frequency_hz: np.ndarray  # (F,)
    magnitude_db: np.ndarray  # (F, T); empty (0, 0) when `display` is set
    display: Optional[SpectrogramDisplayData] = None


def _check_lengths(dsp: FileDsp, settings: SpectrogramAnalysisSettings):
    if settings.n_fft <= 0 or settings.hop_length <= 0:
        raise ValueError("n_fft and hop_length must be positive.")
    starts, seg_lens = dsp.aligned_host_meta(
        settings.trim_to_peak, settings.ignore_leading_seconds, settings.analysis_duration_seconds
    )
    if int(seg_lens.min()) < settings.n_fft:
        raise ValueError("Not enough samples after trimming/selection for spectrogram (need at least n_fft).")
    return starts, seg_lens


def analyse_spectrogram_channels(
    dsp: FileDsp,
    settings: SpectrogramAnalysisSettings,
) -> List[ChannelSpectrogramResult]:
    """All channels from the file's shared STFT (one kernel launch)."""
    starts, seg_lens = _check_lengths(dsp, settings)
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


def analyse_spectrogram_display(
    dsp: FileDsp,
    settings: SpectrogramAnalysisSettings,
    plot_settings: SpectrogramPlotSettings,
) -> List[ChannelSpectrogramResult]:
    """
    The display-resolution spectrogram of the report: the (C, T, F) dB
    plane stays on the device and only the log-frequency max-pooled image
    and the colour percentiles are fetched. Results carry `display` instead
    of `magnitude_db`; the "image" renderer and the summary use them.
    """
    starts, seg_lens = _check_lengths(dsp, settings)
    stft_dev = dsp.stft_db(
        settings.trim_to_peak,
        settings.ignore_leading_seconds,
        settings.analysis_duration_seconds,
        int(settings.n_fft),
        int(settings.hop_length),
        bool(settings.use_hann_window),
        float(settings.floor_db),
    )
    nyquist = 0.5 * float(dsp.sample_rate_hz)
    f_min = float(np.clip(settings.f_min_hz, 1.0, nyquist))
    f_max = float(np.clip(settings.f_max_hz, f_min, nyquist))
    # each channel's valid frame count, as the kernel counts them
    frames_per_ch = np.array(
        [stft.num_frames_static(int(l), int(settings.n_fft), int(settings.hop_length)) for l in seg_lens],
        np.int64,
    )
    images, p995, p5 = display.pooled_log_freq_image(
        stft_dev.mag_db,
        frames_per_ch,
        int(settings.n_fft),
        dsp.sample_rate_hz,
        f_min,
        f_max,
        rows=int(plot_settings.image_rows),
    )
    results = []
    for i, channel_name in enumerate(dsp.channel_names):
        t_valid = int(frames_per_ch[i])
        results.append(
            ChannelSpectrogramResult(
                channel_name=str(channel_name),
                sample_rate_hz=dsp.sample_rate_hz,
                analysis_start_sample_index=int(starts[i]),
                analysis_length_samples=int(seg_lens[i]),
                time_seconds=stft.frame_times_seconds(t_valid, settings.hop_length, dsp.sample_rate_hz),
                frequency_hz=stft.rfft_freqs_hz(settings.n_fft, dsp.sample_rate_hz),
                magnitude_db=np.zeros((0, 0), np.float32),
                display=SpectrogramDisplayData(
                    image=images[i],
                    p995_db=float(p995[i]),
                    p5_db=float(p5[i]),
                    n_fft=int(settings.n_fft),
                    num_frames=t_valid,
                ),
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


def spectrogram_color_limits(
    mag_db: np.ndarray,
    analysis_settings: SpectrogramAnalysisSettings,
    plot_settings: SpectrogramPlotSettings,
) -> tuple:
    """
    The colour scale (reference spectrogram.py:278-289): vmax = the 99.5th
    percentile of the displayed magnitudes (unless pinned), vmin = vmax -
    dynamic_range_db (or the 5th percentile without a range).
    """
    vmax = float(plot_settings.vmax_db) if plot_settings.vmax_db is not None else float(np.percentile(mag_db, 99.5))
    if plot_settings.vmin_db is not None:
        vmin = float(plot_settings.vmin_db)
    elif analysis_settings.dynamic_range_db is not None:
        vmin = vmax - float(analysis_settings.dynamic_range_db)
    else:
        vmin = float(np.percentile(mag_db, 5.0))
    return vmin, vmax


def _display_color_limits(
    display_data: SpectrogramDisplayData,
    analysis_settings: SpectrogramAnalysisSettings,
    plot_settings: SpectrogramPlotSettings,
) -> tuple:
    """spectrogram_color_limits with the percentiles from the device."""
    vmax = float(plot_settings.vmax_db) if plot_settings.vmax_db is not None else float(display_data.p995_db)
    if plot_settings.vmin_db is not None:
        vmin = float(plot_settings.vmin_db)
    elif analysis_settings.dynamic_range_db is not None:
        vmin = vmax - float(analysis_settings.dynamic_range_db)
    else:
        vmin = float(display_data.p5_db)
    return vmin, vmax


def _midpoint_edges(values: np.ndarray, fallback_step: float) -> np.ndarray:
    v = values.astype(np.float64)
    if v.size == 1:
        return np.array([v[0], v[0] + fallback_step])
    d = np.diff(v)
    return np.concatenate(([v[0] - 0.5 * d[0]], v[:-1] + 0.5 * d, [v[-1] + 0.5 * d[-1]]))


def _log_f_image_axis(plot, axis, f_min: float, f_max: float) -> None:
    """A y axis linear in log10(f), labelled in Hz."""
    axis.set_ylabel("Frequency (Hz)")
    ticks = plot.hz_major_ticks(f_min, f_max)
    axis.set_yticks([np.log10(v) for v in ticks])
    axis.set_yticklabels([plot.hz_tick_formatter(v) for v in ticks])
    axis.set_ylim(np.log10(f_min), np.log10(f_max))


def plot_spectrogram_figure(
    result: ChannelSpectrogramResult,
    analysis_settings: SpectrogramAnalysisSettings,
    plot_settings: SpectrogramPlotSettings,
    title: Optional[str] = None,
):
    from audio_analysis_tpu_torch import plot

    figure, axis = plot.create_figure_and_axis(title=title)
    nyquist = 0.5 * float(result.sample_rate_hz)
    f_min = float(np.clip(analysis_settings.f_min_hz, 1.0, nyquist))
    f_max = float(np.clip(analysis_settings.f_max_hz, f_min, nyquist))
    t_edges = _midpoint_edges(result.time_seconds, 1e-3)
    extent = (float(t_edges[0]), float(t_edges[-1]), np.log10(f_min), np.log10(f_max))

    if result.display is not None:
        # the device-pooled image, its percentiles from the device
        vmin, vmax = _display_color_limits(result.display, analysis_settings, plot_settings)
        mesh = axis.imshow(
            result.display.image, origin="lower", aspect="auto", interpolation="nearest",
            extent=extent, vmin=vmin, vmax=vmax,
        )
        _log_f_image_axis(plot, axis, f_min, f_max)
        axis.set_xlabel("Time (s)")
        axis.grid(True, which="both", linestyle=":", linewidth=0.5)
        figure.colorbar(mesh, ax=axis, label="Magnitude (dB)")
        return figure

    fmask = (result.frequency_hz >= f_min) & (result.frequency_hz <= f_max)
    freq = result.frequency_hz[fmask]
    mag = result.magnitude_db[fmask, :]
    if mag.size == 0:
        raise ValueError("Spectrogram frequency selection is empty (check f_min_hz/f_max_hz).")
    vmin, vmax = spectrogram_color_limits(mag, analysis_settings, plot_settings)

    if str(plot_settings.renderer).lower() == "quadmesh":
        f_edges = np.maximum(_midpoint_edges(freq, 1.0), 1e-6)
        mesh = axis.pcolormesh(t_edges, f_edges, mag, shading="auto", vmin=vmin, vmax=vmax)
        axis.set_ylabel("Frequency (Hz)")
        axis.set_yscale("log")
        axis.set_ylim(f_min, f_max)
        plot.apply_log_hz_yaxis(axis)
    else:
        # the (F, T) plane max-pooled onto uniform log10(f) rows, one raster
        image, _ = plot.log_frequency_image(mag, freq, f_min, f_max, rows=int(plot_settings.image_rows))
        mesh = axis.imshow(
            image, origin="lower", aspect="auto", interpolation="nearest", extent=extent, vmin=vmin, vmax=vmax,
        )
        _log_f_image_axis(plot, axis, f_min, f_max)

    axis.set_xlabel("Time (s)")
    axis.grid(True, which="both", linestyle=":", linewidth=0.5)
    figure.colorbar(mesh, ax=axis, label="Magnitude (dB)")
    return figure


def plot_spectrogram_from_wav_file(
    input_wav_file_path: str | Path,
    analysis_settings: Optional[SpectrogramAnalysisSettings] = None,
    plot_settings: Optional[SpectrogramPlotSettings] = None,
    output_basename: Optional[str | Path] = None,
    show_interactive: bool = True,
    dsp: Optional[FileDsp] = None,
    device: "str | torch.device" = "cuda",
) -> List[ChannelSpectrogramResult]:
    if analysis_settings is None:
        analysis_settings = SpectrogramAnalysisSettings()
    if plot_settings is None:
        plot_settings = SpectrogramPlotSettings()
    results = analyse_spectrogram_from_wav_file(input_wav_file_path, analysis_settings, dsp=dsp, device=device)
    render_spectrogram_plots(
        results, analysis_settings, plot_settings, output_basename, show_interactive, input_wav_file_path
    )
    return results


def _update_spectrogram_figure(
    figure,
    state: dict,
    result: ChannelSpectrogramResult,
    analysis_settings: SpectrogramAnalysisSettings,
    plot_settings: SpectrogramPlotSettings,
    title: str,
) -> None:
    """Re-apply the data-dependent artists of plot_spectrogram_figure
    ("image" renderer) to a live template figure; mirrors its data path
    exactly (tests/test_torch_report.py holds the PNGs byte-identical)."""
    from audio_analysis_tpu_torch import plot

    nyquist = 0.5 * float(result.sample_rate_hz)
    f_min = float(np.clip(analysis_settings.f_min_hz, 1.0, nyquist))
    f_max = float(np.clip(analysis_settings.f_max_hz, f_min, nyquist))
    if result.display is not None:
        vmin, vmax = _display_color_limits(result.display, analysis_settings, plot_settings)
        image = result.display.image
    else:
        fmask = (result.frequency_hz >= f_min) & (result.frequency_hz <= f_max)
        mag = result.magnitude_db[fmask, :]
        if mag.size == 0:
            raise ValueError("Spectrogram frequency selection is empty (check f_min_hz/f_max_hz).")
        vmin, vmax = spectrogram_color_limits(mag, analysis_settings, plot_settings)
        image, _ = plot.log_frequency_image(
            mag, result.frequency_hz[fmask], f_min, f_max, rows=int(plot_settings.image_rows)
        )
    t_edges = _midpoint_edges(result.time_seconds, 1e-3)
    mesh = state["mesh"]
    mesh.set_data(image)
    mesh.set_clim(vmin, vmax)
    mesh.set_extent((float(t_edges[0]), float(t_edges[-1]), np.log10(f_min), np.log10(f_max)))
    state["axis"].set_title(title)


def render_spectrogram_plots(
    results: List[ChannelSpectrogramResult],
    analysis_settings: SpectrogramAnalysisSettings,
    plot_settings: SpectrogramPlotSettings,
    output_basename: Optional[str | Path],
    show_interactive: bool,
    title_source: str | Path,
) -> None:
    """Figures and save only (host matplotlib); results come from analyse_*."""
    from audio_analysis_tpu_torch import plot

    use_template = (
        output_basename is not None
        and not show_interactive
        and str(plot_settings.renderer).lower() != "quadmesh"
    )
    for result in results:
        title = f"Spectrogram — {title_source} — {result.channel_name}"
        output_path = (
            None if output_basename is None else suffixed_png(output_basename, f"_spectrogram_{result.channel_name}")
        )
        if not use_template:
            fig = plot_spectrogram_figure(result, analysis_settings, plot_settings, title)
            plot.finalize_and_show_or_save(fig, output_path, show_interactive)
            continue

        def build(result=result, title=title):
            fig = plot_spectrogram_figure(result, analysis_settings, plot_settings, title)
            axis = fig.axes[0]
            return fig, {"axis": axis, "mesh": axis.images[0]}

        def update(fig, state, result=result, title=title):
            _update_spectrogram_figure(fig, state, result, analysis_settings, plot_settings, title)

        plot.save_via_template(
            kind="spectrogram",
            key=(analysis_settings, plot_settings, int(result.sample_rate_hz)),
            build=build,
            update=update,
            output_path=output_path,
        )


def summarise_spectrogram_results_text(results: List[ChannelSpectrogramResult]) -> str:
    lines = []
    for r in results:
        duration_s = float(r.analysis_length_samples) / float(r.sample_rate_hz)
        if r.display is not None:
            n_fft, frames = r.display.n_fft, r.display.num_frames
        else:
            n_fft, frames = r.magnitude_db.shape[0] * 2 - 2, r.magnitude_db.shape[1]
        lines.append(
            f"[{r.channel_name}] start_sample={r.analysis_start_sample_index}  "
            f"len_samples={r.analysis_length_samples}  dur={duration_s:.3f}s  "
            f"stft(n_fft={n_fft}, frames={frames})"
        )
    return "\n".join(lines)
