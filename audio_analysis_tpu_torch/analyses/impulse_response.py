"""
Impulse-response waveform views (audio_analysis_tpu/analyses/
impulse_response.py): the full waveform, the early zoom (default 80 ms)
and the dB tail of |x|, written as `<basename>.png`, `<basename>_early.png`
and `<basename>_tail.png`; and the per-channel stats that `ir --json`
writes. Host numpy only, as in the JAX package; matplotlib is imported by
the figure functions only.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from audio_analysis_tpu_torch.io.wav import LoadedAudio, get_analysis_channels, load_wav_file


@dataclass(frozen=True)
class ImpulseResponseViewSettings:
    early_window_seconds: float = 0.08
    log_magnitude_floor_db: float = -120.0
    use_mono_downmix: bool = False


def compute_log_magnitude(samples: np.ndarray) -> np.ndarray:
    """Magnitude envelope for log plotting (plain abs)."""
    return np.abs(samples).astype(np.float32)


def _suffix_output_path(output_path: str | Path, suffix: str) -> Path:
    output_path = Path(output_path)
    return output_path.with_name(f"{output_path.stem}{suffix}{output_path.suffix}")


def plot_impulse_response_waveform(
    loaded_audio: LoadedAudio,
    settings: ImpulseResponseViewSettings,
    output_path: Optional[str | Path] = None,
    show_interactive: bool = True,
) -> None:
    """The full waveform (min-max decimated) and the early zoom."""
    from audio_analysis_tpu_torch import plot

    total = loaded_audio.samples.shape[0]
    sr = loaded_audio.sample_rate_hz
    time_axis = plot.time_axis_from_sample_count(total, sr)
    channels = get_analysis_channels(loaded_audio, settings.use_mono_downmix)
    plot_channels = [(name, samples, 1.0 if idx == 0 else 0.5) for idx, (name, samples) in enumerate(channels)]

    def _axis_setup(axis):
        plot.label_time_axis_seconds(axis)
        plot.label_amplitude_axis(axis)

    full_lines = []
    for name, samples, alpha in plot_channels:
        t_plot, y_plot = plot.decimate_minmax(time_axis, samples)
        full_lines.append((t_plot, y_plot, {"label": name, "alpha": alpha}))
    plot.render_line_figure(
        "ir_full",
        (settings,),
        f"Waveform (full) - {loaded_audio.file_path.name}",
        full_lines,
        output_path,
        show_interactive,
        legend_kwargs={"loc": "best"},
        setup=_axis_setup,
    )

    early_n = max(1, min(int(round(settings.early_window_seconds * sr)), total))
    early_lines = [
        (time_axis[:early_n], samples[:early_n], {"label": name, "alpha": alpha})
        for name, samples, alpha in plot_channels
    ]
    plot.render_line_figure(
        "ir_early",
        (settings,),
        f"Waveform (early {settings.early_window_seconds * 1000:.0f} ms) - {loaded_audio.file_path.name}",
        early_lines,
        None if output_path is None else _suffix_output_path(output_path, "_early"),
        show_interactive,
        legend_kwargs={"loc": "best"},
        setup=_axis_setup,
    )


def plot_impulse_response_log_magnitude(
    loaded_audio: LoadedAudio,
    settings: ImpulseResponseViewSettings,
    output_path: Optional[str | Path] = None,
    show_interactive: bool = True,
) -> None:
    """The dB tail of |x|, floored, min-max decimated."""
    from audio_analysis_tpu_torch import plot

    total = loaded_audio.samples.shape[0]
    time_axis = plot.time_axis_from_sample_count(total, loaded_audio.sample_rate_hz)
    channels = get_analysis_channels(loaded_audio, settings.use_mono_downmix)
    floor_db = float(settings.log_magnitude_floor_db)
    lines = []
    for idx, (name, samples) in enumerate(channels):
        magnitude = np.maximum(compute_log_magnitude(samples), 10.0 ** (floor_db / 20.0))
        t_plot, y_plot = plot.decimate_minmax(time_axis, 20.0 * np.log10(magnitude))
        lines.append((t_plot, y_plot, {"alpha": 1.0 if idx == 0 else 0.5, "label": name}))

    def _axis_setup(axis):
        axis.set_ylim(bottom=floor_db)
        plot.label_time_axis_seconds(axis)
        plot.label_decibel_axis(axis)

    plot.render_line_figure(
        "ir_tail",
        (settings,),
        f"Log magnitude (tail) - {loaded_audio.file_path.name}",
        lines,
        output_path,
        show_interactive,
        legend_kwargs=None if settings.use_mono_downmix else {},
        setup=_axis_setup,
    )


def _load(wav_file_path: str | Path) -> LoadedAudio:
    return load_wav_file(wav_file_path, expected_channel_mode="mono_or_stereo", allow_mono_and_upmix_to_stereo=False)


def _ir_stats(loaded: LoadedAudio) -> dict:
    x = loaded.samples  # (N, C)
    sr = int(loaded.sample_rate_hz)
    channels = []
    for c in range(x.shape[1]):
        mag = np.abs(x[:, c])
        peak = int(np.argmax(mag))
        channels.append(
            {
                "peak_sample_index": peak,
                "peak_abs": float(mag[peak]),
                "num_samples": int(x.shape[0]),
                "duration_seconds": float(x.shape[0] / sr),
            }
        )
    return {"sample_rate_hz": sr, "channels": channels}


def analyse_ir_from_wav_file(
    wav_file_path: str | Path,
    settings: Optional[ImpulseResponseViewSettings] = None,
) -> dict:
    """The deterministic per-channel stats the IR views show: the peak's
    index and magnitude, the length and duration of every channel of the
    file (the views' settings change only the figures)."""
    return _ir_stats(_load(wav_file_path))


def plot_ir_from_wav_file(
    wav_file_path: str | Path,
    settings: Optional[ImpulseResponseViewSettings] = None,
    output_basename: Optional[str | Path] = None,
    show_interactive: bool = True,
) -> dict:
    """Writes <basename>.png, <basename>_early.png and <basename>_tail.png
    when saving; returns the stats of analyse_ir_from_wav_file."""
    if settings is None:
        settings = ImpulseResponseViewSettings()
    loaded = _load(wav_file_path)
    if output_basename is None:
        waveform_path = tail_path = None
    else:
        base = Path(output_basename)
        waveform_path = base.with_suffix(".png")
        tail_path = base.with_name(f"{base.stem}_tail.png")
    plot_impulse_response_waveform(loaded, settings, waveform_path, show_interactive)
    plot_impulse_response_log_magnitude(loaded, settings, tail_path, show_interactive)
    return _ir_stats(loaded)
