"""
The per-file analyses of the port (audio_analysis_tpu/analyses). Each
module keeps the JAX module's settings, plot settings and result
dataclasses (same fields, defaults and order, so the --json output has the
same keys) and its `analyse_*_channels`, `analyse_*_for_channel`,
`analyse_*_from_wav_file` and `summarise_*_text` functions, which take a
torch `device` (default cuda) where the JAX package used its default
backend. The figure halves (`plot_*_figure`, `render_*_plots`,
`plot_*_from_wav_file`) take host
numpy results and import matplotlib (the port's `plot`) inside
themselves, so importing an analysis loads no matplotlib.

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

from audio_analysis_tpu_torch.analyses.decay import DecayAnalysisSettings, DecayPlotSettings
from audio_analysis_tpu_torch.analyses.deconvolve import DeconvolveSettings
from audio_analysis_tpu_torch.analyses.diffusion import DiffusionAnalysisSettings
from audio_analysis_tpu_torch.analyses.filterplot import FilterAnalysisSettings, FilterPlotSettings
from audio_analysis_tpu_torch.analyses.frequency_response import (
    FrequencyResponseAnalysisSettings,
    FrequencyResponsePlotSettings,
)
from audio_analysis_tpu_torch.analyses.group_delay import GroupDelayAnalysisSettings, GroupDelayPlotSettings
from audio_analysis_tpu_torch.analyses.impulse_response import ImpulseResponseViewSettings
from audio_analysis_tpu_torch.analyses.modalcloud import ModalCloudAnalysisSettings, ModalCloudPlotSettings
from audio_analysis_tpu_torch.analyses.rt60bands import Rt60BandsAnalysisSettings, Rt60BandsPlotSettings
from audio_analysis_tpu_torch.analyses.spectrogram import SpectrogramAnalysisSettings, SpectrogramPlotSettings
from audio_analysis_tpu_torch.analyses.waterfall import WaterfallAnalysisSettings, WaterfallPlotSettings
from audio_analysis_tpu_torch.analyses.zplane import ZPlaneAnalysisSettings, ZPlanePlotSettings

_SETTINGS = {
    cls.__name__: cls
    for cls in (
        DecayAnalysisSettings,
        DecayPlotSettings,
        DeconvolveSettings,
        DiffusionAnalysisSettings,
        FilterAnalysisSettings,
        FilterPlotSettings,
        FrequencyResponseAnalysisSettings,
        FrequencyResponsePlotSettings,
        GroupDelayAnalysisSettings,
        GroupDelayPlotSettings,
        ImpulseResponseViewSettings,
        ModalCloudAnalysisSettings,
        ModalCloudPlotSettings,
        Rt60BandsAnalysisSettings,
        Rt60BandsPlotSettings,
        SpectrogramAnalysisSettings,
        SpectrogramPlotSettings,
        WaterfallAnalysisSettings,
        WaterfallPlotSettings,
        ZPlaneAnalysisSettings,
        ZPlanePlotSettings,
    )
}


def _settings_class(name: str):
    """The port's dataclass of that name; the report's ReportSettings and
    BundleRunSettings are looked up in report/, which imports this package."""
    if name not in _SETTINGS:
        from audio_analysis_tpu_torch.report.bundle import BundleRunSettings
        from audio_analysis_tpu_torch.report.report import ReportSettings

        _SETTINGS.update({cls.__name__: cls for cls in (ReportSettings, BundleRunSettings)})
    return _SETTINGS[name]


def settings_from_jax(obj):
    """The port's settings dataclass of the same class name as `obj` (a
    JAX package settings dataclass, or any dataclass with its fields),
    field by field, nested settings included (ReportSettings' per-module
    settings, BundleRunSettings' ReportSettings)."""
    cls = _settings_class(type(obj).__name__)
    fields = {}
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        fields[f.name] = settings_from_jax(value) if dataclasses.is_dataclass(value) else value
    return cls(**fields)
