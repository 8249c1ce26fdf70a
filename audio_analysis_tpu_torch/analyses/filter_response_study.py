"""
One-pole filter cutoff-mapping study (audio_analysis_tpu/analyses/
filter_response_study.py): the realised attenuation at the requested
cutoff of the exponential ("analog RC") and the prewarped bilinear pole
mappings, as deviations from the ideal -3.01 dB, and their figure. Run as:

    python -m audio_analysis_tpu_torch.analyses.filter_response_study [out.png]
"""

from __future__ import annotations

import sys
from typing import Optional, Tuple

import numpy as np

TARGET_DB_AT_FC = -3.0103  # half-power point


def onepole_magnitude_at_fc(pole: np.ndarray, fc_hz: np.ndarray, sr: int) -> np.ndarray:
    """|H(e^{jw})| at w = 2*pi*fc/sr for H(z) = (1-p) / (1 - p z^-1)."""
    w = 2.0 * np.pi * fc_hz / sr
    num = 1.0 - pole
    den = np.sqrt(1.0 - 2.0 * pole * np.cos(w) + pole * pole)
    return num / den


def pole_mapping_exponential(fc_hz: np.ndarray, sr: int) -> np.ndarray:
    """p = exp(-2*pi*fc/sr): the classic 'analog RC' discretisation."""
    return np.exp(-2.0 * np.pi * fc_hz / sr)


def pole_mapping_tan(fc_hz: np.ndarray, sr: int) -> np.ndarray:
    """p = (1 - tan(pi*fc/sr)) / (1 + tan(pi*fc/sr)): bilinear-prewarped."""
    t = np.tan(np.pi * fc_hz / sr)
    return (1.0 - t) / (1.0 + t)


def attenuation_error_curves(
    sr: int = 48_000, f_min: float = 20.0, f_max: float = 20_000.0, points: int = 512
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fc_hz, error_db_exponential, error_db_tan): the realised attenuation
    at fc minus the ideal -3.01 dB, per mapping."""
    fc = np.geomspace(f_min, min(f_max, sr * 0.45), points)
    err = []
    for mapping in (pole_mapping_exponential, pole_mapping_tan):
        mag = onepole_magnitude_at_fc(mapping(fc, sr), fc, sr)
        err.append(20.0 * np.log10(np.maximum(mag, 1e-12)) - TARGET_DB_AT_FC)
    return fc, err[0], err[1]


def plot_study(output_path: Optional[str] = None) -> None:
    from audio_analysis_tpu_torch import plot

    fc, err_exp, err_tan = attenuation_error_curves()
    figure, axis = plot.create_figure_and_axis(title="One-pole cutoff mapping error at fc")
    axis.plot(fc, err_exp, label="p = exp(-2πfc/sr)")
    axis.plot(fc, err_tan, label="p = (1-tan)/(1+tan) (prewarped)")
    axis.axhline(0.0, linestyle=":", linewidth=1.0)
    plot.apply_log_hz_xaxis(axis, fc[0], fc[-1])
    axis.set_ylabel("Attenuation error at fc (dB, vs -3.01 dB)")
    axis.legend(loc="best")
    plot.finalize_and_show_or_save(figure, output_path, show_interactive=output_path is None)


if __name__ == "__main__":
    plot_study(sys.argv[1] if len(sys.argv) > 1 else None)
