"""
The per-file analyses of the port (audio_analysis_tpu/analyses), analysis
and summary halves; the figures are not ported yet. Each module keeps the
JAX module's settings and result dataclasses (same fields, defaults and
order, so the --json output has the same keys) and its
`analyse_*_channels`, `analyse_*_for_channel`, `analyse_*_from_wav_file`
and `summarise_*_text` functions, which take a torch `device` (default
cuda) where the JAX package used its default backend.

  decay, rt60bands          EDC through kernel K1 (ops.edc)
  spectrogram, waterfall,   dB STFT through kernel K2 (ops.stft)
  modalcloud
  frequency_response,       torch.fft (ops.spectral, ops.diffusion);
  group_delay, filterplot,  fr, group_delay and filterplot also have the
  diffusion, deconvolve     host float64 `exact_grid` version
  zplane                    float32 AR Gram products (ops.spectral), host
                            float64 solve and roots
  impulse_response,         host numpy only
  filter_response_study
"""

from __future__ import annotations

import dataclasses

from audio_analysis_tpu_torch.analyses.decay import DecayAnalysisSettings
from audio_analysis_tpu_torch.analyses.deconvolve import DeconvolveSettings
from audio_analysis_tpu_torch.analyses.diffusion import DiffusionAnalysisSettings
from audio_analysis_tpu_torch.analyses.filterplot import FilterAnalysisSettings
from audio_analysis_tpu_torch.analyses.frequency_response import FrequencyResponseAnalysisSettings
from audio_analysis_tpu_torch.analyses.group_delay import GroupDelayAnalysisSettings
from audio_analysis_tpu_torch.analyses.impulse_response import ImpulseResponseViewSettings
from audio_analysis_tpu_torch.analyses.modalcloud import ModalCloudAnalysisSettings
from audio_analysis_tpu_torch.analyses.rt60bands import Rt60BandsAnalysisSettings
from audio_analysis_tpu_torch.analyses.spectrogram import SpectrogramAnalysisSettings
from audio_analysis_tpu_torch.analyses.waterfall import WaterfallAnalysisSettings
from audio_analysis_tpu_torch.analyses.zplane import ZPlaneAnalysisSettings

_SETTINGS = {
    cls.__name__: cls
    for cls in (
        DecayAnalysisSettings,
        DeconvolveSettings,
        DiffusionAnalysisSettings,
        FilterAnalysisSettings,
        FrequencyResponseAnalysisSettings,
        GroupDelayAnalysisSettings,
        ImpulseResponseViewSettings,
        ModalCloudAnalysisSettings,
        Rt60BandsAnalysisSettings,
        SpectrogramAnalysisSettings,
        WaterfallAnalysisSettings,
        ZPlaneAnalysisSettings,
    )
}


def settings_from_jax(obj):
    """The port's settings dataclass of the same class name as `obj` (a
    JAX package settings dataclass, or any dataclass with its fields),
    field by field, nested settings included."""
    cls = _SETTINGS[type(obj).__name__]
    fields = {}
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        fields[f.name] = settings_from_jax(value) if dataclasses.is_dataclass(value) else value
    return cls(**fields)
