"""
The report suite (audio_analysis_tpu/report/report.py): the standard set
of analyses on one WAV, assembled into `<basename>_report.md` with the
PNGs beside it and the deterministic text summaries: IR views, decay, RT60
bands, frequency response, group delay, spectrogram, waterfall, diffusion
(report defaults hop 0.05 s, max lag 5 ms) and modal cloud, in that order,
with the same markdown as the JAX package.

One FileDsp per report: the signal is uploaded once, the alignment is
computed once, spectrogram and waterfall share one 4096-point STFT (kernel
K2) and the modal cloud adds one 8192-point STFT; decay and rt60bands run
kernel K1 once each. The spectrogram's dB plane stays on the device; only
its pooled display image crosses (ops.display). Figures render on a plot
worker (parallel.overlap) from numpy results while the next block's device
work runs; the markdown is written after every figure of the report has
been drawn, unless a caller-owned worker is passed.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from functools import partial
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from audio_analysis_tpu_torch.analyses._common import FileDsp
from audio_analysis_tpu_torch.analyses.decay import (
    DecayAnalysisSettings,
    DecayPlotSettings,
    analyse_decay_from_wav_file,
    render_decay_plots,
    summarise_decay_results_text,
)
from audio_analysis_tpu_torch.analyses.diffusion import (
    DiffusionAnalysisSettings,
    analyse_diffusion_from_wav_file,
    render_diffusion_plots,
    summarise_diffusion_results_text,
)
from audio_analysis_tpu_torch.analyses.frequency_response import (
    FrequencyResponseAnalysisSettings,
    FrequencyResponsePlotSettings,
    analyse_frequency_response_from_wav_file,
    render_frequency_response_plots,
    summarise_frequency_response_results_text,
)
from audio_analysis_tpu_torch.analyses.group_delay import (
    GroupDelayAnalysisSettings,
    GroupDelayPlotSettings,
    analyse_group_delay_from_wav_file,
    render_group_delay_plots,
    summarise_group_delay_results_text,
)
from audio_analysis_tpu_torch.analyses.impulse_response import ImpulseResponseViewSettings, plot_ir_from_wav_file
from audio_analysis_tpu_torch.analyses.modalcloud import (
    ModalCloudAnalysisSettings,
    ModalCloudPlotSettings,
    analyse_modal_cloud_from_wav_file,
    render_modal_cloud_plots,
    summarise_modal_cloud_results_text,
)
from audio_analysis_tpu_torch.analyses.rt60bands import (
    Rt60BandsAnalysisSettings,
    Rt60BandsPlotSettings,
    analyse_rt60_bands_from_wav_file,
    render_rt60_bands_plots,
    summarise_rt60_bands_results_text,
)
from audio_analysis_tpu_torch.analyses.spectrogram import (
    SpectrogramAnalysisSettings,
    SpectrogramPlotSettings,
    analyse_spectrogram_display,
    analyse_spectrogram_from_wav_file,
    render_spectrogram_plots,
    summarise_spectrogram_results_text,
)
from audio_analysis_tpu_torch.analyses.waterfall import (
    WaterfallAnalysisSettings,
    WaterfallPlotSettings,
    analyse_waterfall_from_wav_file,
    render_waterfall_plots,
    summarise_waterfall_results_text,
)
from audio_analysis_tpu_torch.io.wav import DEFAULT_EXPECTED_SAMPLE_RATE_HZ, load_wav_file
from audio_analysis_tpu_torch.parallel.overlap import BorrowedPlotWorker, MaybePlotWorker, make_plot_worker
from audio_analysis_tpu_torch.utils.timing import BlockTimer


@dataclass(frozen=True)
class ReportSettings:
    common_use_mono_downmix_for_stereo: bool = False
    common_trim_to_peak: bool = True
    common_ignore_leading_seconds: float = 0.0

    run_impulse_response_plots: bool = True
    run_decay: bool = True
    run_rt60_bands: bool = True
    run_frequency_response: bool = True
    run_group_delay: bool = True
    run_spectrogram: bool = True
    run_waterfall: bool = True
    run_diffusion: bool = True
    run_modal_cloud: bool = True
    run_echo_density: bool = True  # echo density ships inside the diffusion block
    include_timing_footer: bool = False  # per-block wall-clock table at the end
    overlap_plotting: bool = True  # render figures on a worker thread
    # > 0: render figures on a spawn-based process pool of this many
    # workers (parallel/procpool.py); 0: the single-thread worker
    plot_processes: int = 0
    # bundle runs: build every figure template on the render worker(s) as
    # the first job, beside the first tap's device work (report/warmup.py)
    warmup_figure_templates: bool = True

    expected_sample_rate_hz: int = DEFAULT_EXPECTED_SAMPLE_RATE_HZ

    ir_view_settings: Optional[ImpulseResponseViewSettings] = None
    decay_analysis_settings: Optional[DecayAnalysisSettings] = None
    decay_plot_settings: Optional[DecayPlotSettings] = None
    rt60_bands_settings: Optional[Rt60BandsAnalysisSettings] = None
    rt60_bands_plot_settings: Optional[Rt60BandsPlotSettings] = None
    frequency_response_analysis_settings: Optional[FrequencyResponseAnalysisSettings] = None
    frequency_response_plot_settings: Optional[FrequencyResponsePlotSettings] = None
    group_delay_analysis_settings: Optional[GroupDelayAnalysisSettings] = None
    group_delay_plot_settings: Optional[GroupDelayPlotSettings] = None
    spectrogram_analysis_settings: Optional[SpectrogramAnalysisSettings] = None
    spectrogram_plot_settings: Optional[SpectrogramPlotSettings] = None
    waterfall_analysis_settings: Optional[WaterfallAnalysisSettings] = None
    waterfall_plot_settings: Optional[WaterfallPlotSettings] = None
    diffusion_analysis_settings: Optional[DiffusionAnalysisSettings] = None
    modal_cloud_analysis_settings: Optional[ModalCloudAnalysisSettings] = None
    modal_cloud_plot_settings: Optional[ModalCloudPlotSettings] = None


@dataclass(frozen=True)
class ReportResults:
    input_wav_file_path: Path
    output_basename: Path
    summary_markdown_path: Path
    summary_markdown: str


def _md_section(title: str) -> str:
    return f"\n## {title}\n\n"


def _md_codeblock(text: str) -> str:
    text = text.strip()
    if not text:
        return "_(no output)_\n"
    return f"```text\n{text}\n```\n"


def _md_image(basename: Path, suffix: str, alt_text: str = "") -> str:
    filename = f"{basename.name}{suffix}.png"
    return f"![{alt_text or filename}]({filename})\n\n"


def _apply_common_overrides(settings_obj: Any, report_settings: ReportSettings) -> Any:
    """Push the three common knobs into any settings dataclass that has them."""
    if settings_obj is None:
        return None
    field_names = {f.name for f in dataclasses.fields(settings_obj)}
    kwargs: Dict[str, Any] = {}
    if "use_mono_downmix_for_stereo" in field_names:
        kwargs["use_mono_downmix_for_stereo"] = report_settings.common_use_mono_downmix_for_stereo
    if "use_mono_downmix" in field_names:
        kwargs["use_mono_downmix"] = report_settings.common_use_mono_downmix_for_stereo
    if "trim_to_peak" in field_names:
        kwargs["trim_to_peak"] = report_settings.common_trim_to_peak
    if "ignore_leading_seconds" in field_names:
        kwargs["ignore_leading_seconds"] = report_settings.common_ignore_leading_seconds
    return replace(settings_obj, **kwargs) if kwargs else settings_obj


def _format_header_block(input_wav_file_path: Path, expected_sample_rate_hz: int) -> str:
    loaded = load_wav_file(
        input_wav_file_path,
        expected_sample_rate_hz=expected_sample_rate_hz,
        expected_channel_mode="stereo",
        allow_mono_and_upmix_to_stereo=True,
    )
    n_samples = int(loaded.samples.shape[0])
    sr = int(loaded.sample_rate_hz)
    ch = int(loaded.samples.shape[1])
    duration = n_samples / sr if sr > 0 else 0.0
    return (
        "# Offline Reverb Analysis Report\n\n"
        f"**Input WAV:** `{input_wav_file_path}`  \n"
        f"**Sample rate:** {sr} Hz (expected {expected_sample_rate_hz} Hz)  \n"
        f"**Channels:** {ch}  \n"
        f"**Samples:** {n_samples}  \n"
        f"**Duration:** {duration:.6f} s\n\n"
        "---\n"
    )


def run_report_from_wav_file(
    input_wav_file_path: str | Path,
    output_basename: str | Path,
    settings: Optional[ReportSettings] = None,
    plot_worker: Optional[MaybePlotWorker] = None,
    device: "str | torch.device" = "cuda",
) -> ReportResults:
    """
    One WAV -> the analysis suite on `device` -> PNGs + <basename>_report.md.

    `plot_worker`: a caller-owned worker defers figure rendering across
    reports (the bundle runner overlaps tap k's figures with tap k+1's
    device work); the caller drains it. Without one the report owns a
    worker and drains it before the markdown is written.
    """
    if settings is None:
        settings = ReportSettings()
    input_wav_file_path = Path(input_wav_file_path)
    output_basename = Path(output_basename)
    output_basename.parent.mkdir(parents=True, exist_ok=True)

    timer = BlockTimer()
    md: List[str] = [_format_header_block(input_wav_file_path, settings.expected_sample_rate_hz)]
    dsp = FileDsp.from_wav_file(input_wav_file_path, settings.common_use_mono_downmix_for_stereo, device)
    # image suffixes come from the actual channel set (a mono input
    # without --mono still yields one "mono" channel)
    left_name = dsp.channel_names[0]
    right_name = dsp.channel_names[1] if len(dsp.channel_names) > 1 else None

    def images(suffix: str, alt: str, alt_right: str) -> None:
        md.append(_md_image(output_basename, f"{suffix}_{left_name}", alt))
        if right_name:
            md.append(_md_image(output_basename, f"{suffix}_{right_name}", alt_right))

    def common(settings_obj: Any) -> Any:
        return _apply_common_overrides(settings_obj, settings)

    plots_cm = (
        BorrowedPlotWorker(plot_worker, default_label=str(output_basename))
        if plot_worker is not None
        else make_plot_worker(settings.overlap_plotting, settings.plot_processes)
    )
    with plots_cm as plots:
        if settings.run_impulse_response_plots:
            with timer.block("impulse_response"):
                ir_settings = common(settings.ir_view_settings or ImpulseResponseViewSettings())
                plots.submit(
                    partial(plot_ir_from_wav_file, input_wav_file_path, ir_settings, output_basename,
                            show_interactive=False)
                )
                md.append(_md_section("Impulse response"))
                md.append(_md_image(output_basename, "", "Impulse response overview"))
                md.append(_md_image(output_basename, "_early", "Early reflections"))
                md.append(_md_image(output_basename, "_tail", "Tail (log magnitude)"))
        if settings.run_decay:
            with timer.block("decay"):
                decay_settings = common(settings.decay_analysis_settings or DecayAnalysisSettings())
                decay_results = analyse_decay_from_wav_file(input_wav_file_path, decay_settings, dsp=dsp)
                plots.submit(
                    partial(render_decay_plots, decay_results, decay_settings,
                            settings.decay_plot_settings or DecayPlotSettings(), output_basename, False,
                            input_wav_file_path)
                )
                md.append(_md_section("Decay / EDC"))
                md.append(_md_image(output_basename, "_decay", "Decay analysis (T20/T30/RT60/EDT)"))
                md.append(_md_codeblock(summarise_decay_results_text(decay_results)))
        if settings.run_rt60_bands:
            with timer.block("rt60_bands"):
                rt60_settings = common(settings.rt60_bands_settings or Rt60BandsAnalysisSettings())
                # the common knobs live on the nested decay settings
                rt60_settings = replace(rt60_settings, decay_settings=common(rt60_settings.decay_settings))
                rt60_results = analyse_rt60_bands_from_wav_file(input_wav_file_path, rt60_settings, dsp=dsp)
                plots.submit(
                    partial(render_rt60_bands_plots, rt60_results, rt60_settings,
                            settings.rt60_bands_plot_settings or Rt60BandsPlotSettings(), output_basename, False,
                            input_wav_file_path)
                )
                md.append(_md_section("RT60 by band"))
                md.append(_md_image(output_basename, "_rt60bands", "RT60 by frequency band"))
                md.append(
                    _md_codeblock(
                        summarise_rt60_bands_results_text(
                            rt60_results,
                            include_t20=bool(rt60_settings.include_t20),
                            include_edt=bool(rt60_settings.include_edt),
                        )
                    )
                )
        if settings.run_frequency_response:
            with timer.block("frequency_response"):
                fr_settings = common(settings.frequency_response_analysis_settings or FrequencyResponseAnalysisSettings())
                fr_results = analyse_frequency_response_from_wav_file(input_wav_file_path, fr_settings, dsp=dsp)
                plots.submit(
                    partial(render_frequency_response_plots, fr_results, fr_settings,
                            settings.frequency_response_plot_settings or FrequencyResponsePlotSettings(),
                            output_basename, False, input_wav_file_path)
                )
                md.append(_md_section("Frequency response"))
                md.append(_md_image(output_basename, "_fr", "Frequency response spectrum"))
                md.append(_md_codeblock(summarise_frequency_response_results_text(fr_results)))
        if settings.run_group_delay:
            with timer.block("group_delay"):
                gd_settings = common(settings.group_delay_analysis_settings or GroupDelayAnalysisSettings())
                gd_results = analyse_group_delay_from_wav_file(input_wav_file_path, gd_settings, dsp=dsp)
                plots.submit(
                    partial(render_group_delay_plots, gd_results,
                            settings.group_delay_plot_settings or GroupDelayPlotSettings(), output_basename, False)
                )
                md.append(_md_section("Group delay"))
                # the per-channel files the renderer writes, as the JAX
                # package embeds them
                images("_groupdelay", "Group delay vs frequency", "Group delay vs frequency (right)")
                md.append(_md_codeblock(summarise_group_delay_results_text(gd_results)))
        if settings.run_spectrogram:
            with timer.block("spectrogram"):
                spec_settings = common(settings.spectrogram_analysis_settings or SpectrogramAnalysisSettings())
                spec_plot_settings = settings.spectrogram_plot_settings or SpectrogramPlotSettings()
                if str(spec_plot_settings.renderer).lower() == "image":
                    # the plane stays on the device; only the pooled
                    # display image and the percentiles cross
                    spec_results = analyse_spectrogram_display(dsp, spec_settings, spec_plot_settings)
                else:
                    spec_results = analyse_spectrogram_from_wav_file(input_wav_file_path, spec_settings, dsp=dsp)
                plots.submit(
                    partial(render_spectrogram_plots, spec_results, spec_settings, spec_plot_settings,
                            output_basename, False, input_wav_file_path)
                )
                md.append(_md_section("Spectrogram"))
                images("_spectrogram", "Spectrogram", "Spectrogram (right)")
                md.append(_md_codeblock(summarise_spectrogram_results_text(spec_results)))
        if settings.run_waterfall:
            with timer.block("waterfall"):
                wf_settings = common(settings.waterfall_analysis_settings or WaterfallAnalysisSettings())
                wf_results = analyse_waterfall_from_wav_file(input_wav_file_path, wf_settings, dsp=dsp)
                plots.submit(
                    partial(render_waterfall_plots, wf_results, wf_settings,
                            settings.waterfall_plot_settings or WaterfallPlotSettings(), output_basename, False,
                            input_wav_file_path)
                )
                md.append(_md_section("Waterfall"))
                images("_waterfall", "Waterfall plot", "Waterfall (right)")
                md.append(_md_codeblock(summarise_waterfall_results_text(wf_results)))
        if settings.run_diffusion:
            with timer.block("diffusion"):
                diff_results = analyse_diffusion_from_wav_file(
                    input_wav_file_path,
                    common(
                        settings.diffusion_analysis_settings
                        or DiffusionAnalysisSettings(hop_seconds=0.05, max_lag_milliseconds=5.0)
                    ),
                    dsp=dsp,
                )
                plots.submit(partial(render_diffusion_plots, diff_results, output_basename, False, input_wav_file_path))
                md.append(_md_section("Diffusion / echo density proxy"))
                md.append(_md_image(output_basename, "_diffusion", "Diffusion metrics over time"))
                md.append(_md_codeblock(summarise_diffusion_results_text(diff_results)))
        if settings.run_modal_cloud:
            with timer.block("modal_cloud"):
                modal_settings = common(settings.modal_cloud_analysis_settings or ModalCloudAnalysisSettings())
                modal_results = analyse_modal_cloud_from_wav_file(input_wav_file_path, modal_settings, dsp=dsp)
                plots.submit(
                    partial(render_modal_cloud_plots, modal_results, modal_settings,
                            settings.modal_cloud_plot_settings or ModalCloudPlotSettings(), output_basename, False,
                            input_wav_file_path)
                )
                md.append(_md_section("Modal cloud"))
                images("_modalcloud", "Modal cloud", "Modal cloud (right)")
                md.append(_md_codeblock(summarise_modal_cloud_results_text(modal_results)))
        with timer.block("plot_render_drain"):
            plots.drain()
    if settings.include_timing_footer:
        md.append(timer.as_markdown())

    summary_markdown = "".join(md).rstrip() + "\n"
    summary_path = Path(f"{output_basename}_report.md")
    summary_path.parent.mkdir(parents=True, exist_ok=True)
    summary_path.write_text(summary_markdown, encoding="utf-8")
    return ReportResults(
        input_wav_file_path=input_wav_file_path,
        output_basename=output_basename,
        summary_markdown_path=summary_path,
        summary_markdown=summary_markdown,
    )
