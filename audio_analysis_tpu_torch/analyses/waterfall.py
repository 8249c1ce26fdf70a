"""
Waterfall (cumulative-spectral-decay style) slices of the STFT
(audio_analysis_tpu/analyses/waterfall.py, analysis and summary; the 3D
and ridge figures are not ported yet): slice modes auto / uniform_time /
uniform_frames, dB relative to the global or per-slice max clipped to
[-dyn, 0], optional per-slice log-frequency smoothing.

The dB plane is one call of kernel K2 through the file's memoised STFT;
only the selected frames are gathered on the device and fetched, in the
1/128-dB fixed point. The settings and the slice policy are the ones the
engine summaries use (report/waterfall.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from audio_analysis_tpu_torch.analyses._common import FileDsp, single_channel_dsp
from audio_analysis_tpu_torch.ops import display, logfreq, stft
from audio_analysis_tpu_torch.report.waterfall import (  # noqa: F401
    WaterfallAnalysisSettings,
    select_slice_frame_indices,
)


@dataclass(frozen=True)
class ChannelWaterfallResult:
    channel_name: str
    sample_rate_hz: int
    analysis_start_sample_index: int
    analysis_length_samples: int
    slice_times_seconds: np.ndarray  # (S,)
    frequency_hz: np.ndarray  # (F,)
    slice_magnitude_rel_db: np.ndarray  # (S, F) in [-dyn, 0]


def _build_rel_db_slices_from(
    slices_db: np.ndarray,
    frame_idx: np.ndarray,
    frame_times: np.ndarray,
    sample_rate_hz: int,
    settings: WaterfallAnalysisSettings,
    f_min: float,
    f_max: float,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(slice_times (S,), freq (F,), rel_db (S, F)) from the frequency-
    selected slices of one channel (host)."""
    if frame_idx.size < 2:
        raise ValueError("Not enough slices selected for waterfall (increase duration or num_slices).")

    freq_hz = stft.rfft_freqs_hz(settings.n_fft, sample_rate_hz)
    fmask = (freq_hz >= f_min) & (freq_hz <= f_max)
    if not np.any(fmask):
        raise ValueError("Waterfall frequency selection is empty (check f_min_hz/f_max_hz).")
    f_sel = freq_hz[fmask].astype(np.float32)
    slices_db = np.asarray(slices_db, np.float32)  # (S, F_sel)

    if settings.smoothing_log_bins and int(settings.smoothing_log_bins) > 1:
        slices_db = logfreq.smooth_mag_db_log_frequency(
            f_sel,
            torch.from_numpy(slices_db),
            f_min,
            f_max,
            int(settings.smoothing_log_bins),
            int(settings.log_bins_per_octave),
        ).numpy()

    if str(settings.db_reference).lower() == "slice_max":
        rel = slices_db - slices_db.max(axis=1, keepdims=True)
    else:
        rel = slices_db - float(slices_db.max())
    dyn = float(max(10.0, settings.dynamic_range_db))
    rel = np.clip(rel, -dyn, 0.0).astype(np.float32)
    return frame_times[frame_idx].astype(np.float32), f_sel, rel


def analyse_waterfall_channels(
    dsp: FileDsp,
    settings: WaterfallAnalysisSettings,
) -> List[ChannelWaterfallResult]:
    """All channels from the file's shared STFT (one kernel launch)."""
    starts, seg_lens = dsp.aligned_host_meta(
        settings.trim_to_peak, settings.ignore_leading_seconds, settings.analysis_duration_seconds
    )
    if int(seg_lens.min()) < settings.n_fft:
        raise ValueError("Not enough samples after trimming/selection for waterfall (need at least n_fft).")

    stft_dev = dsp.stft_db(
        settings.trim_to_peak,
        settings.ignore_leading_seconds,
        settings.analysis_duration_seconds,
        int(settings.n_fft),
        int(settings.hop_length),
        bool(settings.use_hann_window),
        float(settings.floor_db),
    )
    nyq = float(stft.rfft_freqs_hz(settings.n_fft, dsp.sample_rate_hz)[-1])
    f_min = float(np.clip(settings.f_min_hz, 1.0, nyq))
    f_max = float(np.clip(settings.f_max_hz, f_min, nyq))

    # each channel's slice frames, from its valid frame count (host meta)
    frames_per_ch = [
        stft.num_frames_static(int(l), int(settings.n_fft), int(settings.hop_length)) for l in seg_lens
    ]
    frame_times = [stft.frame_times_seconds(t, settings.hop_length, dsp.sample_rate_hz) for t in frames_per_ch]
    idx_per_ch = [select_slice_frame_indices(ft, settings) for ft in frame_times]
    idx_padded = np.zeros((len(idx_per_ch), max(ix.size for ix in idx_per_ch)), np.int32)
    for i, ix in enumerate(idx_per_ch):
        idx_padded[i, : ix.size] = ix
        idx_padded[i, ix.size :] = ix[-1] if ix.size else 0
    slices_host = display.stft_frame_slices(
        stft_dev.mag_db, idx_padded, int(settings.n_fft), dsp.sample_rate_hz, f_min, f_max
    )  # (C, S_max, F_sel)

    results = []
    for i, channel_name in enumerate(dsp.channel_names):
        slice_times, f_sel, rel = _build_rel_db_slices_from(
            slices_host[i][: idx_per_ch[i].size],
            idx_per_ch[i],
            frame_times[i],
            dsp.sample_rate_hz,
            settings,
            f_min,
            f_max,
        )
        results.append(
            ChannelWaterfallResult(
                channel_name=str(channel_name),
                sample_rate_hz=dsp.sample_rate_hz,
                analysis_start_sample_index=int(starts[i]),
                analysis_length_samples=int(seg_lens[i]),
                slice_times_seconds=slice_times,
                frequency_hz=f_sel,
                slice_magnitude_rel_db=rel,
            )
        )
    return results


def analyse_waterfall_for_channel(
    samples: np.ndarray,
    sample_rate_hz: int,
    channel_name: str,
    settings: WaterfallAnalysisSettings,
    device: "str | torch.device" = "cuda",
) -> ChannelWaterfallResult:
    return analyse_waterfall_channels(
        single_channel_dsp(samples, sample_rate_hz, channel_name, device), settings
    )[0]


def analyse_waterfall_from_wav_file(
    input_wav_file_path: str | Path,
    settings: Optional[WaterfallAnalysisSettings] = None,
    dsp: Optional[FileDsp] = None,
    device: "str | torch.device" = "cuda",
) -> List[ChannelWaterfallResult]:
    if settings is None:
        settings = WaterfallAnalysisSettings()
    if dsp is None:
        dsp = FileDsp.from_wav_file(input_wav_file_path, settings.use_mono_downmix_for_stereo, device)
    return analyse_waterfall_channels(dsp, settings)


def summarise_waterfall_results_text(results: List[ChannelWaterfallResult]) -> str:
    lines = []
    for r in results:
        dur = float(r.analysis_length_samples) / float(r.sample_rate_hz)
        lines.append(
            f"[{r.channel_name}] start_sample={r.analysis_start_sample_index}  dur={dur:.3f}s  "
            f"slices={int(r.slice_times_seconds.size)}  f_bins={int(r.frequency_hz.size)}"
        )
    return "\n".join(lines)
