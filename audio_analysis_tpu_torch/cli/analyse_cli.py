"""
The port's analyse CLI: every subcommand of
audio_analysis_tpu/cli/analyse_cli.py with the same flags, defaults,
messages, stdout and exit codes.

    python -m audio_analysis_tpu_torch.cli bundle --input <root> --no-plots [--compare PREV --fail-on-change]
    python -m audio_analysis_tpu_torch.cli bundle --input <root> [--resume] [--tap-shard I/N] [--plot-processes N]
    python -m audio_analysis_tpu_torch.cli bundle --input <root> --multi-host --coordinator H:P --num-processes N --process-id I
    python -m audio_analysis_tpu_torch.cli batch --inputs a.wav b.wav --output <dir> [--no-plots]
    python -m audio_analysis_tpu_torch.cli watch --input <recorder output dir> [--plots]
    python -m audio_analysis_tpu_torch.cli compare <previous run> <current run>
    python -m audio_analysis_tpu_torch.cli report --input ir.wav --output <dir>/<base>
    python -m audio_analysis_tpu_torch.cli decay --input ir.wav [--output <base>] [--no_show] [--json out.json]
        (likewise ir, rt60bands, fr, filter, spectrogram, diffusion,
        waterfall, modalcloud; groupdelay and zplane spell it --no-show;
        fr, filter and groupdelay take --exact-grid)
    python -m audio_analysis_tpu_torch.cli deconvolve --recorded_wav_file_path r.wav --sweep_wav_file_path s.wav

`--device` picks the torch device (default cuda; `--device cpu` runs the
plain torch versions of the kernels on the host). Without CUDA, a command
that takes --device exits at once unless `--device cpu` is given. Figures
(`report`, `bundle`/`batch` without --no-plots, `watch --plots`, a per-file command with
--output or without --no_show / --no-show) need matplotlib: where it does
not import, such a command exits before any work with a message naming
it. Under a headless backend the interactive show is a no-op, as in the
JAX CLI.

`bundle --multi-host` runs one rank of a multi-host job
(engine.distributed): with `--coordinator H:P` it joins a gloo process group
of `--num-processes` ranks as `--process-id`; without it, torchrun's
environment, or one process alone. Each rank analyses and reports its own
taps on its device (`--device cuda`: cuda:(LOCAL_RANK or the rank) modulo
the visible devices; `--device cpu`: the plain versions), and only rank 0
prints the index line and exits 3 on flagged changes.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import replace
from functools import partial
from typing import Optional, Sequence

import torch

from audio_analysis_tpu_torch.engine.config import EngineConfig
from audio_analysis_tpu_torch.report.compare import (
    count_flagged_in_text,
    format_bundle_comparison,
    index_has_flagged_changes,
    load_bundle_metrics,
)
from audio_analysis_tpu_torch.report.engine_report import (
    EngineBundleSettings,
    run_bundle_report_engine,
)

BoolOpt = argparse.BooleanOptionalAction


def _add_engine_config_flags(p: argparse.ArgumentParser) -> None:
    """Tri-state engine knobs shared by the engine paths (bundle --no-plots,
    batch, watch): absent = EngineConfig default; --flag / --no-flag force
    it."""
    p.add_argument("--bands-decimate", dest="bands_decimate", action=BoolOpt,
                   default=None,
                   help="Run band EDC/fits on spectrum-crop decimated planes where the "
                        "band's oversampling margin allows (exact band samples; see "
                        "EngineConfig.bands_decimate). --no-bands-decimate restores "
                        "full-rate planes for every band.")
    p.add_argument("--modal-trim-bins", dest="modal_trim_bins", action=BoolOpt,
                   default=None,
                   help="Trim the modal STFT at the last log-bin-weighted rfft bin "
                        "(EngineConfig.modal_trim_bins, default on).")
    p.add_argument("--prefetch-chunks", dest="prefetch_chunks", type=int, default=None,
                   help="Audio chunks decoded + uploaded ahead of the one being computed "
                        "(EngineBundleSettings.prefetch_chunks, default 2; 1 = serialized "
                        "pipeline).")


def _add_input(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--input",
        dest="input_wav_file_path",
        type=str,
        required=True,
        help="Path to input WAV file (mono or stereo, 48 kHz expected).",
    )


def _add_output_noshow(p: argparse.ArgumentParser, help_text: str, underscore: bool) -> None:
    p.add_argument("--output", dest="output_basename", type=str, default=None, help=help_text)
    flag = "--no_show" if underscore else "--no-show"
    p.add_argument(flag, dest="no_show", action="store_true",
                   help="Do not display plots interactively (useful when saving files).")
    p.add_argument("--json", dest="json_path", type=str, default=None,
                   help="Also write the result tree as JSON to this path.")


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", dest="device", type=str, default="cuda",
                   help="torch device to run on (default cuda; cpu runs the plain torch "
                        "versions of the kernels).")


def _engine_config(args: argparse.Namespace) -> EngineConfig:
    """EngineConfig from --bands and the tri-state flags of
    _add_engine_config_flags (None = keep the default)."""
    overrides = {}
    for name in ("bands_decimate", "modal_trim_bins"):
        value = getattr(args, name, None)
        if value is not None:
            overrides[name] = bool(value)
    return replace(EngineConfig(), band_mode=str(args.band_mode), **overrides)


def _engine_settings(args: argparse.Namespace, **kwargs) -> EngineBundleSettings:
    """EngineBundleSettings from the shared engine-path flags."""
    if args.prefetch_chunks is not None:
        kwargs["prefetch_chunks"] = max(1, int(args.prefetch_chunks))
    return EngineBundleSettings(
        reports_subdir=str(args.reports_subdir),
        use_mono_downmix_for_stereo=bool(args.use_mono_downmix),
        config=_engine_config(args),
        **kwargs,
    )


def build_parser() -> argparse.ArgumentParser:
    top = argparse.ArgumentParser(
        prog="analyse",
        description="Offline analysis of reverb outputs on a CUDA device (PyTorch port).",
    )
    sub = top.add_subparsers(dest="command_name", required=True,
                             help="Analysis to run. Use: analyse <command> --help")

    # --- bundle ---
    p = sub.add_parser("bundle", help="Analyse an IR bundle folder (meta.json + taps/*.wav).")
    p.add_argument("--input", dest="bundle_root", type=str, required=True)
    p.add_argument("--reports-subdir", dest="reports_subdir", type=str, default="reports")
    p.add_argument("--resume", action="store_true",
                   help="Skip taps whose report already exists.")
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true",
                   help="Downmix stereo to mono in every tap report.")
    p.add_argument("--no-plots", dest="no_plots", action="store_true",
                   help="Engine fast path: text/JSON metric reports only, one fused device "
                        "pass a chunk of taps (no PNG rendering).")
    p.add_argument("--bands", dest="band_mode", type=str, default="three",
                   choices=["three", "octave", "third"],
                   help="RT60 band mode (rt60bands.py band modes).")
    _add_engine_config_flags(p)
    p.add_argument("--plot-processes", dest="plot_processes", type=int, default=0,
                   help="Render figures on a process pool of this many workers "
                        "(multi-core hosts); 0 = single render thread.")
    p.add_argument("--compare", dest="compare_to", type=str, default=None, metavar="PREV",
                   help="With --no-plots: diff this run's headline metrics against a "
                        "previous run's bundle_metrics.json (file, reports dir, or bundle "
                        "root; the current reports dir works, the previous file is read "
                        "before it is overwritten) and append a 'Changes vs previous' "
                        "section to the index.")
    p.add_argument("--compare-threshold", dest="compare_threshold", type=float, default=1.0,
                   metavar="PCT", help="Relative change (%%) above which --compare flags "
                        "a metric (default 1.0).")
    p.add_argument("--fail-on-change", dest="fail_on_change", action="store_true",
                   help="With --compare: exit 3 when any change is flagged.")
    p.add_argument("--tap-shard", dest="tap_shard", type=str, default=None, metavar="I/N",
                   help="Render only taps with index %% N == I (0-based): fan the plot "
                        "bundle over N processes or machines sharing the filesystem, then "
                        "merge the index with one --resume run.")
    p.add_argument("--multi-host", dest="multi_host", action="store_true",
                   help="Multi-host engine path: every rank analyses and reports its own taps, "
                        "rank 0 writes the index (engine.distributed).")
    p.add_argument("--coordinator", dest="coordinator", type=str, default=None,
                   help="host:port of the gloo process group's rendezvous (with --multi-host, "
                        "when torchrun's environment does not give it).")
    p.add_argument("--num-processes", dest="num_processes", type=int, default=None)
    p.add_argument("--process-id", dest="process_id", type=int, default=None)
    _add_device(p)

    # --- batch (loose WAV files through the bundle tooling) ---
    p = sub.add_parser(
        "batch",
        help="Analyse a set of loose WAV files as one batch: materialises a "
             "bundle view (meta.json + tap symlinks) in --output, then runs "
             "the bundle path over it (plot reports, or --no-plots).",
    )
    p.add_argument("--inputs", dest="input_wav_paths", type=str, nargs="+", required=True,
                   help="WAV files to analyse (shell globs expand naturally).")
    p.add_argument("--output", dest="bundle_root", type=str, required=True,
                   help="Directory for the bundle view + reports (created).")
    p.add_argument("--reports-subdir", dest="reports_subdir", type=str, default="reports")
    p.add_argument("--resume", action="store_true",
                   help="Skip files whose plot report already exists.")
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true")
    p.add_argument("--no-plots", dest="no_plots", action="store_true",
                   help="Engine fast path: text/JSON metric reports only.")
    p.add_argument("--bands", dest="band_mode", type=str, default="three",
                   choices=["three", "octave", "third"])
    _add_engine_config_flags(p)
    p.add_argument("--plot-processes", dest="plot_processes", type=int, default=0)
    p.add_argument("--compare", dest="compare_to", type=str, default=None, metavar="PREV")
    p.add_argument("--compare-threshold", dest="compare_threshold", type=float,
                   default=1.0, metavar="PCT")
    p.add_argument("--fail-on-change", dest="fail_on_change", action="store_true")
    _add_device(p)

    # --- watch ---
    p = sub.add_parser(
        "watch",
        help="Watch a recorder output dir: analyse each new complete bundle "
             "(engine fast path) and diff it against the previous run.",
    )
    p.add_argument("--input", dest="watch_root", type=str, required=True,
                   help="Directory the recorder writes timestamped bundles into "
                        "(or a single bundle dir, re-analysed when re-recorded).")
    p.add_argument("--interval", dest="poll_seconds", type=float, default=2.0,
                   help="Poll interval in seconds (default 2).")
    p.add_argument("--reports-subdir", dest="reports_subdir", type=str, default="reports")
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true")
    p.add_argument("--bands", dest="band_mode", type=str, default="three",
                   choices=["three", "octave", "third"])
    _add_engine_config_flags(p)
    p.add_argument("--no-compare", dest="no_compare", action="store_true",
                   help="Skip the automatic diff against the previously analysed bundle.")
    p.add_argument("--compare-threshold", dest="compare_threshold", type=float, default=1.0,
                   metavar="PCT")
    p.add_argument("--max-bundles", dest="max_bundles", type=int, default=None,
                   help="Exit after analysing this many bundles (default: run forever).")
    p.add_argument("--plots", dest="watch_plots", action="store_true",
                   help="Also render the full plot report per bundle (into "
                        "<reports-subdir>_plots; host-bound, seconds a tap).")
    p.add_argument("--plot-processes", dest="plot_processes", type=int, default=0)
    _add_device(p)

    # --- compare (host only) ---
    p = sub.add_parser(
        "compare",
        help="Diff two existing engine runs' headline metrics "
             "(bundle_metrics.json files, reports dirs, or bundle roots).",
    )
    p.add_argument("previous", type=str, help="Older run (the baseline).")
    p.add_argument("current", type=str, help="Newer run.")
    p.add_argument("--threshold", "--compare-threshold", dest="compare_threshold",
                   type=float, default=1.0, metavar="PCT",
                   help="Relative change (%%) to flag (default 1.0; "
                        "--compare-threshold accepted for bundle-flag parity).")
    p.add_argument("--fail-on-change", dest="fail_on_change", action="store_true",
                   help="Exit 3 when any change is flagged.")

    _add_per_file_parsers(sub)
    return top


def _add_per_file_parsers(sub) -> None:
    """The per-file subcommands and `report`, with the JAX CLI's flags,
    dests, defaults and choices, plus --device."""
    # --- ir ---
    p = sub.add_parser("ir", help="Waveform (full + early zoom) and log-magnitude tail view.")
    _add_input(p)
    p.add_argument("--early-window", dest="early_window_seconds", type=float, default=0.08)
    p.add_argument("--floor-db", dest="log_magnitude_floor_db", type=float, default=-120.0)
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true")
    _add_output_noshow(p, "Save PNGs: <basename>.png, _early.png, _tail.png", underscore=True)
    _add_device(p)

    # --- zplane ---
    p = sub.add_parser("zplane", help="Estimate poles (and optional zeros) from an IR.")
    _add_input(p)
    _add_output_noshow(p, "Output basename -> <basename>_zplane_<CH>.png", underscore=False)
    p.add_argument("--mono", dest="use_mono_downmix_for_stereo", action="store_true")
    p.add_argument("--no-trim", dest="trim_to_peak", action="store_false")
    p.add_argument("--ignore-leading", dest="ignore_leading_seconds", type=float, default=0.0)
    p.add_argument("--duration", dest="analysis_duration_seconds", type=float, default=None)
    p.add_argument("--ar-order", dest="ar_order", type=int, default=256)
    p.add_argument("--zeros", dest="derive_zeros", action="store_true")
    p.add_argument("--zero-order", dest="zero_order", type=int, default=64)
    p.add_argument("--radius", dest="limit_radius", type=float, default=1.2,
                   help="Plot radius.")
    p.add_argument("--ridge", dest="ridge_lambda", type=float, default=0.0)
    _add_device(p)

    # --- groupdelay ---
    p = sub.add_parser("groupdelay", help="Group delay vs frequency from an IR/filter output.")
    _add_input(p)
    _add_output_noshow(p, "Output basename -> <basename>_groupdelay_<CH>.png", underscore=False)
    p.add_argument("--mono", dest="use_mono_downmix_for_stereo", action="store_true")
    p.add_argument("--no-trim", dest="trim_to_peak", action="store_false")
    p.add_argument("--ignore-leading", dest="ignore_leading_seconds", type=float, default=0.0)
    p.add_argument("--duration", dest="analysis_duration_seconds", type=float, default=None)
    p.add_argument("--fft", dest="fft_size", type=int, default=None)
    p.add_argument("--smooth", dest="smoothing_bins", type=int, default=0)
    p.add_argument("--fmin", dest="f_min_hz", type=float, default=20.0)
    p.add_argument("--fmax", dest="f_max_hz", type=float, default=20000.0)
    p.add_argument("--exact-grid", dest="exact_grid", action="store_true",
                   help="Host float64 on the reference's exact next-pow2 FFT grid.")
    _add_device(p)

    # --- deconvolve ---
    p = sub.add_parser("deconvolve", help="Deconvolve recorded sweep output into an IR WAV.")
    p.add_argument("--recorded_wav_file_path", type=str, required=True)
    p.add_argument("--sweep_wav_file_path", type=str, required=True)
    p.add_argument("--output_ir_wav_file_path", type=str, default=None)
    p.add_argument("--regularization_relative", type=float, default=1e-10)
    p.add_argument("--normalise_peak", action=BoolOpt, default=True)
    p.add_argument("--target_peak", type=float, default=0.95)
    p.add_argument("--remove_dc", action=BoolOpt, default=True)
    p.add_argument("--output_length_mode", type=str, choices=["recorded", "full_fft"],
                   default="recorded")
    _add_device(p)

    # --- decay ---
    p = sub.add_parser("decay", help="Schroeder EDC + T20/T30/RT60 decay estimation")
    _add_input(p)
    _add_output_noshow(p, "If provided, saves a PNG: <basename>_decay.png", underscore=True)
    p.add_argument("--trim_to_peak", action=BoolOpt, default=True)
    p.add_argument("--ignore-leading", dest="ignore_leading_seconds", type=float, default=0.0)
    p.add_argument("--edc_floor_db", type=float, default=-120.0)
    p.add_argument("--fit_lower_limit_db", type=float, default=-80.0)
    p.add_argument("--smoothing", dest="edc_smoothing_window_samples", type=int, default=0)
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true", default=False)
    p.add_argument("--compute_edt", action=BoolOpt, default=True)
    _add_device(p)

    # --- rt60bands ---
    p = sub.add_parser("rt60bands", help="Band-limited RT60: Low/Mid/High T30 (optional T20/EDT).")
    _add_input(p)
    _add_output_noshow(p, "If provided, saves one PNG: <basename>_rt60bands.png", underscore=True)
    p.add_argument("--band_mode", type=str, default="three", choices=["three", "octave", "third"])
    p.add_argument("--f_min_hz", type=float, default=31.5)
    p.add_argument("--f_max_hz", type=float, default=16000.0)
    p.add_argument("--legend_values", action=BoolOpt, default=None)
    p.add_argument("--low_upper_hz", type=float, default=250.0)
    p.add_argument("--mid_center_hz", type=float, default=1000.0)
    p.add_argument("--mid_width_octaves", type=float, default=2.0)
    p.add_argument("--high_lower_hz", type=float, default=4000.0)
    p.add_argument("--transition_width_octaves", type=float, default=1.0 / 6.0)
    p.add_argument("--include_t20", action="store_true")
    p.add_argument("--include_edt", action="store_true")
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true")
    p.add_argument("--trim_to_peak", action="store_true", default=True)
    p.add_argument("--ignore-leading", dest="ignore_leading_seconds", type=float, default=0.0)
    p.add_argument("--edc_floor_db", type=float, default=-120.0)
    p.add_argument("--fit_lower_limit_db", type=float, default=-80.0)
    p.add_argument("--smoothing", dest="edc_smoothing_window_samples", type=int, default=0)
    _add_device(p)

    # --- fr ---
    p = sub.add_parser("fr", help="Magnitude spectrum (dB) vs frequency.")
    _add_input(p)
    _add_output_noshow(p, "If provided, saves a PNG: <basename>_fr.png", underscore=True)
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true")
    p.add_argument("--trim_to_peak", action=BoolOpt, default=True)
    p.add_argument("--ignore-leading", dest="ignore_leading_seconds", type=float, default=0.0)
    p.add_argument("--duration", dest="analysis_duration_seconds", type=float, default=None)
    p.add_argument("--magnitude_floor_db", type=float, default=-120.0)
    p.add_argument("--f_min_hz", type=float, default=20.0)
    p.add_argument("--f_max_hz", type=float, default=20000.0)
    p.add_argument("--smoothing_log_bins", type=int, default=0)
    p.add_argument("--log_bins_per_octave", type=int, default=96)
    p.add_argument("--no_hann_window", action="store_true")
    p.add_argument("--exact-grid", dest="exact_grid", action="store_true",
                   help="Host float64 on the reference's exact segment-length FFT grid.")
    _add_device(p)

    # --- filter ---
    p = sub.add_parser("filter", help="Filter frequency response: magnitude (dB) and phase.")
    _add_input(p)
    _add_output_noshow(p, "If provided, saves a PNG: <basename>_filter.png", underscore=True)
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true")
    p.add_argument("--trim_to_peak", action=BoolOpt, default=True)
    p.add_argument("--ignore-leading", dest="ignore_leading_seconds", type=float, default=0.0)
    p.add_argument("--duration", dest="analysis_duration_seconds", type=float, default=None)
    p.add_argument("--magnitude_floor_db", type=float, default=-120.0)
    p.add_argument("--f_min_hz", type=float, default=20.0)
    p.add_argument("--f_max_hz", type=float, default=20000.0)
    p.add_argument("--phase_mode", type=str, choices=["degrees", "radians"], default="degrees")
    p.add_argument("--no_unwrap_phase", action="store_true")
    p.add_argument("--no_hann_window", action="store_true")
    p.add_argument("--exact-grid", dest="exact_grid", action="store_true",
                   help="Host float64 on the reference's exact segment-length FFT grid.")
    _add_device(p)

    # --- spectrogram ---
    p = sub.add_parser("spectrogram", help="Time-frequency magnitude spectrogram.")
    _add_input(p)
    _add_output_noshow(p, "Saves PNG(s): <basename>_spectrogram_<CH>.png", underscore=True)
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true")
    p.add_argument("--trim_to_peak", action=BoolOpt, default=True)
    p.add_argument("--ignore-leading", dest="ignore_leading_seconds", type=float, default=0.0)
    p.add_argument("--duration", dest="analysis_duration_seconds", type=float, default=None)
    p.add_argument("--n_fft", type=int, default=4096)
    p.add_argument("--hop_length", type=int, default=512)
    p.add_argument("--no_hann_window", action="store_true")
    p.add_argument("--floor_db", type=float, default=-120.0)
    p.add_argument("--f_min_hz", type=float, default=20.0)
    p.add_argument("--f_max_hz", type=float, default=20000.0)
    p.add_argument("--dynamic_range_db", type=float, default=90.0,
                   help="Color scale range below max (default: 90). 0 -> percentiles.")
    p.add_argument("--renderer", type=str, choices=["image", "quadmesh"], default="image",
                   help="image: log-frequency raster (fast, default); quadmesh: the "
                        "reference's per-bin QuadMesh.")
    _add_device(p)

    # --- diffusion ---
    p = sub.add_parser("diffusion",
                       help="Diffusion metrics over time: autocorr, echo density, decorrelation.")
    _add_input(p)
    _add_output_noshow(p, "If provided, saves one PNG: <basename>_diffusion.png", underscore=True)
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true")
    p.add_argument("--trim_to_peak", action=BoolOpt, default=True)
    p.add_argument("--ignore-leading", dest="ignore_leading_seconds", type=float, default=0.0)
    p.add_argument("--window_seconds", type=float, default=0.050)
    p.add_argument("--hop_seconds", type=float, default=0.010)
    p.add_argument("--max_lag_milliseconds", type=float, default=10.0)
    p.add_argument("--echo_density_threshold_rms", type=float, default=1.0)
    p.add_argument("--echo_density_normalise_to_gaussian", action=BoolOpt, default=True)
    _add_device(p)

    # --- waterfall ---
    p = sub.add_parser("waterfall", help="Waterfall (CSD-style): spectral slices over time.")
    _add_input(p)
    _add_output_noshow(p, "Saves PNG(s): <basename>_waterfall_<CH>.png", underscore=True)
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true")
    p.add_argument("--trim_to_peak", action=BoolOpt, default=True)
    p.add_argument("--ignore-leading", dest="ignore_leading_seconds", type=float, default=0.0)
    p.add_argument("--duration", dest="analysis_duration_seconds", type=float, default=None)
    p.add_argument("--n_fft", type=int, default=4096)
    p.add_argument("--hop_length", type=int, default=512)
    p.add_argument("--no_hann_window", action="store_true")
    p.add_argument("--f_min_hz", type=float, default=20.0)
    p.add_argument("--f_max_hz", type=float, default=20000.0)
    p.add_argument("--style", type=str, choices=["3d", "2d"], default="3d")
    p.add_argument("--slice_mode", type=str, choices=["auto", "uniform_time", "uniform_frames"],
                   default="auto")
    p.add_argument("--num_slices", type=int, default=18)
    p.add_argument("--slice_spacing_seconds", type=float, default=0.05)
    p.add_argument("--start_time_seconds", type=float, default=0.0)
    p.add_argument("--end_time_seconds", type=float, default=None)
    p.add_argument("--db_reference", type=str, choices=["global_max", "slice_max"],
                   default="global_max")
    p.add_argument("--dynamic_range_db", type=float, default=80.0)
    p.add_argument("--floor_db", type=float, default=-120.0)
    p.add_argument("--smoothing_log_bins", type=int, default=0)
    p.add_argument("--log_bins_per_octave", type=int, default=96)
    p.add_argument("--elev_deg", type=float, default=30.0)
    p.add_argument("--azim_deg", type=float, default=-60.0)
    p.add_argument("--ridge_offset_db", type=float, default=6.0)
    _add_device(p)

    # --- modalcloud ---
    p = sub.add_parser("modalcloud",
                       help="Modal cloud: frequency vs RT60 points from per-bin STFT decay fits.")
    _add_input(p)
    _add_output_noshow(p, "Saves PNG(s): <basename>_modalcloud_<CH>.png", underscore=True)
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true")
    p.add_argument("--trim_to_peak", action=BoolOpt, default=True)
    p.add_argument("--ignore-leading", dest="ignore_leading_seconds", type=float, default=0.0)
    p.add_argument("--duration", dest="analysis_duration_seconds", type=float, default=None)
    p.add_argument("--n_fft", type=int, default=8192)
    p.add_argument("--hop_length", type=int, default=512)
    p.add_argument("--no_hann_window", action="store_true")
    p.add_argument("--f_min_hz", type=float, default=20.0)
    p.add_argument("--f_max_hz", type=float, default=20000.0)
    p.add_argument("--metric", type=str, choices=["t30", "t20", "edt"], default="t30")
    p.add_argument("--log_bins_per_octave", type=int, default=24)
    p.add_argument("--min_bins", type=int, default=24)
    p.add_argument("--fit_lower_limit_db", type=float, default=-80.0)
    p.add_argument("--min_fit_points", type=int, default=10)
    p.add_argument("--min_peak_db_above_floor", type=float, default=20.0)
    p.add_argument("--floor_db", type=float, default=-120.0)
    p.add_argument("--show_median_curve", action=BoolOpt, default=True)
    p.add_argument("--median_octave_window", type=float, default=0.25)
    p.add_argument("--ylim_seconds_min", type=float, default=None)
    p.add_argument("--ylim_seconds_max", type=float, default=None)
    _add_device(p)

    # --- report ---
    p = sub.add_parser("report", help="Run a standard analysis suite; write plots + summary.")
    _add_input(p)
    p.add_argument("--output", dest="output_basename", type=str, required=True,
                   help="Output basename/prefix (folder + base name).")
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true")
    p.add_argument("--trim_to_peak", action=BoolOpt, default=True)
    p.add_argument("--ignore_leading_seconds", type=float, default=0.0)
    for flag, dest in (("ir", "run_ir"), ("decay", "run_decay"), ("rt60bands", "run_rt60bands"),
                       ("fr", "run_fr"), ("gd", "run_gd"), ("spectrogram", "run_spectrogram"),
                       ("waterfall", "run_waterfall"), ("diffusion", "run_diffusion"),
                       ("modalcloud", "run_modalcloud"), ("echodensity", "run_echodensity")):
        p.add_argument(f"--{flag}", dest=dest, action=BoolOpt, default=True)
    p.add_argument("--timing", dest="include_timing", action="store_true",
                   help="Append a per-block wall-clock table to the report.")
    p.add_argument("--profile-dir", dest="profile_dir", type=str, default=None,
                   help="Write a torch.profiler Chrome trace of the run to this directory.")
    _add_device(p)


def _check_args(cmd: str, args: argparse.Namespace) -> None:
    """The JAX CLI's argument validation of bundle and batch, with its
    messages; runs before any side effect (batch writes its view into
    --output)."""
    if cmd not in ("batch", "bundle"):
        return
    no_plots = bool(args.no_plots)
    multi_host = bool(getattr(args, "multi_host", False))
    if getattr(args, "tap_shard", None) and (no_plots or multi_host):
        raise SystemExit(
            "--tap-shard shards the PLOT bundle; it cannot combine with "
            "--no-plots or --multi-host (the engine paths batch taps themselves)"
        )
    if args.compare_to and not (no_plots or multi_host):
        # dropping --compare on an unwired path would let the
        # --fail-on-change gate pass vacuously
        raise SystemExit(
            "--compare diffs engine metrics: it requires --no-plots or "
            "--multi-host (the metrics source is the engine's "
            "bundle_metrics.json)"
        )
    if bool(args.resume) and no_plots:
        raise SystemExit(
            "--resume skips taps with complete PLOT reports; it cannot "
            "combine with --no-plots (the fused engine always re-analyses "
            "the whole batch - it is the fast path already)"
        )


# the per-file subcommands that draw a figure (deconvolve draws none)
FIGURE_COMMANDS = (
    "ir", "zplane", "decay", "rt60bands", "fr", "filter", "groupdelay", "spectrogram", "diffusion",
    "waterfall", "modalcloud",
)


def _draws_figures(cmd: str, args: argparse.Namespace) -> bool:
    if cmd == "report":
        return True
    if cmd in ("bundle", "batch"):
        return not (bool(args.no_plots) or bool(getattr(args, "multi_host", False)))
    if cmd == "watch":
        return bool(args.watch_plots)
    if cmd in FIGURE_COMMANDS:
        return args.output_basename is not None or not bool(args.no_show)
    return False


def _require_matplotlib(cmd: str) -> None:
    """Exit before any work when the figures asked for cannot be drawn: a
    report is never written without its PNGs."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as exc:
        raise SystemExit(
            f"analyse {cmd}: drawing the figures needs matplotlib, which does not import here "
            f"({exc}); the metrics alone run with --no-plots (bundle, batch), without --plots "
            "(watch), or with --no_show / --no-show and no --output (the per-file commands)"
        ) from None


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    cmd = str(args.command_name)

    if cmd == "compare":
        section = format_bundle_comparison(
            load_bundle_metrics(args.current),
            load_bundle_metrics(args.previous),
            threshold_pct=float(args.compare_threshold),
            previous_label=f"`{args.previous}`",
        )
        print(section.strip())
        if count_flagged_in_text(section) and bool(args.fail_on_change):
            raise SystemExit(3)
        return

    _check_args(cmd, args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"analyse {cmd}: CUDA is not available; pass --device cpu to run the "
            "plain torch versions on the host"
        )
    if _draws_figures(cmd, args):
        _require_matplotlib(cmd)

    if cmd == "deconvolve" or cmd in FIGURE_COMMANDS:
        _run_per_file(cmd, args, device)
        return
    if cmd == "report":
        _run_report(args, device)
        return

    if cmd == "watch":
        from audio_analysis_tpu_torch.report.watch import WatchSettings, watch_bundle_runs

        watch_settings = WatchSettings(
            poll_seconds=float(args.poll_seconds),
            engine=_engine_settings(args),
            compare_to_previous=not bool(args.no_compare),
            compare_threshold_pct=float(args.compare_threshold),
            max_bundles=args.max_bundles,
            plots=bool(args.watch_plots),
            plot_processes=int(args.plot_processes),
        )
        try:
            watch_bundle_runs(str(args.watch_root), watch_settings, device=device)
        except KeyboardInterrupt:
            print("\nwatch stopped")
        return

    if cmd == "batch":
        # loose WAVs -> bundle view in --output, then the bundle path on it
        from audio_analysis_tpu_torch.io import materialize_bundle_view

        try:
            root = materialize_bundle_view(args.input_wav_paths, args.bundle_root)
        except ValueError as exc:  # bad inputs / refusing a real bundle
            raise SystemExit(str(exc)) from None
        print(f"Materialised bundle view: {root} ({len(args.input_wav_paths)} files)")

    if bool(getattr(args, "multi_host", False)):
        _run_multi_host(args, device)
        return
    if not args.no_plots:
        _run_plot_bundle(args, device)
        return
    index = run_bundle_report_engine(
        str(args.bundle_root),
        _engine_settings(
            args,
            compare_to=args.compare_to,
            compare_threshold_pct=float(args.compare_threshold),
        ),
        device,
    )
    print(f"Wrote bundle report index: {index}")
    if args.compare_to and bool(args.fail_on_change) and index_has_flagged_changes(index):
        print("Changes flagged vs previous run (see the index) — exiting 3.")
        raise SystemExit(3)


def _run_multi_host(args: argparse.Namespace, device: torch.device) -> None:
    """`bundle --multi-host`: join the job, run this rank's share, leave
    the process group so that every rank exits cleanly."""
    import torch.distributed as dist

    from audio_analysis_tpu_torch.engine import distributed

    if args.coordinator:
        if args.num_processes is None or args.process_id is None:
            raise SystemExit(
                "bundle --multi-host --coordinator requires both "
                "--num-processes and --process-id"
            )
        distributed.initialize_multi_host(str(args.coordinator), int(args.num_processes), int(args.process_id))
    elif os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"):
        distributed.initialize_multi_host()
    try:
        index = distributed.run_bundle_report_multi_host(
            str(args.bundle_root),
            replace(_engine_config(args), downmix_to_mono=bool(args.use_mono_downmix)),
            reports_subdir=str(args.reports_subdir),
            compare_to=args.compare_to,
            compare_threshold_pct=float(args.compare_threshold),
            devices=[distributed.rank_device(device)],
        )
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if index is not None:
        print(f"Wrote bundle report index: {index}")
        if args.compare_to and bool(args.fail_on_change) and index_has_flagged_changes(index):
            print("Changes flagged vs previous run (see the index) — exiting 3.")
            raise SystemExit(3)


def _run_report(args: argparse.Namespace, device: torch.device) -> None:
    from pathlib import Path

    from audio_analysis_tpu_torch.report.report import ReportSettings, run_report_from_wav_file
    from audio_analysis_tpu_torch.utils.timing import profile_trace

    with profile_trace(args.profile_dir):
        results = run_report_from_wav_file(
            input_wav_file_path=str(args.input_wav_file_path),
            output_basename=str(Path(args.output_basename)),
            settings=ReportSettings(
                common_use_mono_downmix_for_stereo=bool(args.use_mono_downmix),
                common_trim_to_peak=bool(args.trim_to_peak),
                common_ignore_leading_seconds=float(args.ignore_leading_seconds),
                run_impulse_response_plots=bool(args.run_ir),
                run_decay=bool(args.run_decay),
                run_rt60_bands=bool(args.run_rt60bands),
                run_frequency_response=bool(args.run_fr),
                run_group_delay=bool(args.run_gd),
                run_spectrogram=bool(args.run_spectrogram),
                run_waterfall=bool(args.run_waterfall),
                run_diffusion=bool(args.run_diffusion),
                run_modal_cloud=bool(args.run_modalcloud),
                run_echo_density=bool(args.run_echodensity),
                include_timing_footer=bool(args.include_timing),
            ),
            device=device,
        )
    print(results.summary_markdown)
    print(f"Wrote: {results.summary_markdown_path}")


def _run_plot_bundle(args: argparse.Namespace, device: torch.device) -> None:
    """`bundle` / `batch` without --no-plots: one full report per tap."""
    from audio_analysis_tpu_torch.report.bundle import BundleRunSettings, run_bundle_report
    from audio_analysis_tpu_torch.report.report import ReportSettings

    index = run_bundle_report(
        str(args.bundle_root),
        settings=BundleRunSettings(
            reports_subdir=str(args.reports_subdir),
            resume=bool(args.resume),
            tap_shard=getattr(args, "tap_shard", None),
            report_settings=ReportSettings(
                common_use_mono_downmix_for_stereo=bool(args.use_mono_downmix),
                plot_processes=int(args.plot_processes),
            ),
        ),
        device=device,
    )
    if getattr(args, "tap_shard", None):
        print(f"Wrote bundle shard summary: {index}")
        print(f"Merge after all shards finish: analyse.cli bundle --input {args.bundle_root} --resume")
    else:
        print(f"Wrote bundle report index: {index}")


def _maybe_write_json(args: argparse.Namespace, results) -> None:
    if args.json_path:
        from audio_analysis_tpu_torch.utils import write_results_json

        print(f"Wrote JSON: {write_results_json(args.json_path, results)}")


def _run_per_file(cmd: str, args: argparse.Namespace, device: torch.device) -> None:
    """One per-file subcommand: the analysis on `device`, its figures when
    asked for (--output, or a run without --no_show / --no-show), then the
    JAX CLI's stdout (the JSON line first, then the summary)."""
    from audio_analysis_tpu_torch import analyses as an

    path = str(getattr(args, "input_wav_file_path", ""))
    if cmd == "deconvolve":
        output_path = args.output_ir_wav_file_path
        if output_path is None:
            output_path = str(an.deconvolve.default_output_ir_path(args.recorded_wav_file_path))
        result = an.deconvolve.deconvolve_from_wav_files(
            recorded_wav_file_path=str(args.recorded_wav_file_path),
            sweep_wav_file_path=str(args.sweep_wav_file_path),
            settings=an.deconvolve.DeconvolveSettings(
                regularization_relative=float(args.regularization_relative),
                normalise_peak=bool(args.normalise_peak),
                target_peak=float(args.target_peak),
                remove_dc=bool(args.remove_dc),
                output_length_mode=str(args.output_length_mode),
            ),
            output_ir_wav_file_path=output_path,
            device=device,
        )
        print(f"Wrote IR WAV: {output_path}")
        print(f"  sample_rate_hz={result.sample_rate_hz}")
        print(f"  channels={result.samples.shape[1]}")
        print(f"  length_seconds={result.samples.shape[0] / float(result.sample_rate_hz):.3f}")
        return

    figures = _draws_figures(cmd, args)
    out = args.output_basename
    show = not bool(args.no_show)
    if cmd == "ir":
        # host only, as in the JAX package; prints nothing but the JSON line
        settings = an.impulse_response.ImpulseResponseViewSettings(
            early_window_seconds=float(args.early_window_seconds),
            log_magnitude_floor_db=float(args.log_magnitude_floor_db),
            use_mono_downmix=bool(args.use_mono_downmix),
        )
        if figures:
            results = an.impulse_response.plot_ir_from_wav_file(path, settings, out, show)
        else:
            results = an.impulse_response.analyse_ir_from_wav_file(path, settings)
        _maybe_write_json(args, results)
        return

    # each branch: the results, their summary, and the figures' renderer
    if cmd in ("decay", "rt60bands"):
        edt = bool(args.compute_edt) if cmd == "decay" else bool(args.include_edt)
        decay_settings = an.decay.DecayAnalysisSettings(
            trim_to_peak=bool(args.trim_to_peak),
            ignore_leading_seconds=float(args.ignore_leading_seconds),
            edc_floor_db=float(args.edc_floor_db),
            fit_lower_limit_db=float(args.fit_lower_limit_db),
            edc_smoothing_window_samples=int(args.edc_smoothing_window_samples),
            use_mono_downmix_for_stereo=bool(args.use_mono_downmix),
            compute_edt=edt,
        )
        if cmd == "decay":
            results = an.decay.analyse_decay_from_wav_file(path, decay_settings, device=device)
            text = an.decay.summarise_decay_results_text(results)
            render = partial(an.decay.render_decay_plots, results, decay_settings, an.decay.DecayPlotSettings())
        else:
            settings = an.rt60bands.Rt60BandsAnalysisSettings(
                band_mode=str(args.band_mode),
                low_upper_hz=float(args.low_upper_hz),
                mid_center_hz=float(args.mid_center_hz),
                mid_width_octaves=float(args.mid_width_octaves),
                high_lower_hz=float(args.high_lower_hz),
                f_min_hz=float(args.f_min_hz),
                f_max_hz=float(args.f_max_hz),
                transition_width_octaves=float(args.transition_width_octaves),
                include_t20=bool(args.include_t20),
                include_edt=bool(args.include_edt),
                decay_settings=decay_settings,
            )
            results = an.rt60bands.analyse_rt60_bands_from_wav_file(path, settings, device=device)
            text = an.rt60bands.summarise_rt60_bands_results_text(
                results, include_t20=settings.include_t20, include_edt=settings.include_edt
            )
            legend_values = (
                str(args.band_mode) == "three" if args.legend_values is None else bool(args.legend_values)
            )
            render = partial(
                an.rt60bands.render_rt60_bands_plots, results, settings,
                an.rt60bands.Rt60BandsPlotSettings(legend_values=legend_values),
            )
    elif cmd == "fr":
        settings = an.frequency_response.FrequencyResponseAnalysisSettings(
            use_mono_downmix_for_stereo=bool(args.use_mono_downmix),
            trim_to_peak=bool(args.trim_to_peak),
            ignore_leading_seconds=float(args.ignore_leading_seconds),
            analysis_duration_seconds=args.analysis_duration_seconds,
            use_hann_window=not bool(args.no_hann_window),
            magnitude_floor_db=float(args.magnitude_floor_db),
            f_min_hz=float(args.f_min_hz),
            f_max_hz=float(args.f_max_hz),
            smoothing_log_bins=int(args.smoothing_log_bins),
            log_bins_per_octave=int(args.log_bins_per_octave),
            exact_grid=bool(args.exact_grid),
        )
        results = an.frequency_response.analyse_frequency_response_from_wav_file(path, settings, device=device)
        text = an.frequency_response.summarise_frequency_response_results_text(results)
        render = partial(
            an.frequency_response.render_frequency_response_plots, results, settings,
            an.frequency_response.FrequencyResponsePlotSettings(),
        )
    elif cmd == "filter":
        settings = an.filterplot.FilterAnalysisSettings(
            use_mono_downmix_for_stereo=bool(args.use_mono_downmix),
            trim_to_peak=bool(args.trim_to_peak),
            ignore_leading_seconds=float(args.ignore_leading_seconds),
            analysis_duration_seconds=args.analysis_duration_seconds,
            use_hann_window=not bool(args.no_hann_window),
            magnitude_floor_db=float(args.magnitude_floor_db),
            f_min_hz=float(args.f_min_hz),
            f_max_hz=float(args.f_max_hz),
            phase_mode=str(args.phase_mode),
            unwrap_phase=not bool(args.no_unwrap_phase),
            exact_grid=bool(args.exact_grid),
        )
        results = an.filterplot.analyse_filter_response_from_wav_file(path, settings, device=device)
        text = an.filterplot.summarise_filter_response_results_text(results)
        render = partial(
            an.filterplot.render_filter_response_plots, results, settings, an.filterplot.FilterPlotSettings()
        )
    elif cmd == "zplane":
        settings = an.zplane.ZPlaneAnalysisSettings(
            use_mono_downmix_for_stereo=bool(args.use_mono_downmix_for_stereo),
            trim_to_peak=bool(args.trim_to_peak),
            ignore_leading_seconds=float(args.ignore_leading_seconds),
            analysis_duration_seconds=args.analysis_duration_seconds,
            ar_order=int(args.ar_order),
            derive_zeros=bool(args.derive_zeros),
            zero_order=int(args.zero_order),
            ridge_lambda=float(args.ridge_lambda),
        )
        results = an.zplane.analyse_zplane_from_wav_file(path, settings, device=device)
        text = an.zplane.summarise_zplane_results_text(results)
        plot_settings = an.zplane.ZPlanePlotSettings(limit_radius=float(args.limit_radius))

        def render(out, show, _title_source):
            an.zplane.render_zplane_plots(results, settings, plot_settings, out, show)
    elif cmd == "groupdelay":
        settings = an.group_delay.GroupDelayAnalysisSettings(
            use_mono_downmix_for_stereo=bool(args.use_mono_downmix_for_stereo),
            trim_to_peak=bool(args.trim_to_peak),
            ignore_leading_seconds=float(args.ignore_leading_seconds),
            analysis_duration_seconds=args.analysis_duration_seconds,
            fft_size=args.fft_size,
            smoothing_bins=int(args.smoothing_bins),
            f_min_hz=float(args.f_min_hz),
            f_max_hz=float(args.f_max_hz),
            exact_grid=bool(args.exact_grid),
        )
        results = an.group_delay.analyse_group_delay_from_wav_file(path, settings, device=device)
        text = an.group_delay.summarise_group_delay_results_text(results)

        def render(out, show, _title_source):
            an.group_delay.render_group_delay_plots(results, an.group_delay.GroupDelayPlotSettings(), out, show)
    elif cmd == "spectrogram":
        dyn = float(args.dynamic_range_db)
        settings = an.spectrogram.SpectrogramAnalysisSettings(
            use_mono_downmix_for_stereo=bool(args.use_mono_downmix),
            trim_to_peak=bool(args.trim_to_peak),
            ignore_leading_seconds=float(args.ignore_leading_seconds),
            analysis_duration_seconds=args.analysis_duration_seconds,
            n_fft=int(args.n_fft),
            hop_length=int(args.hop_length),
            use_hann_window=not bool(args.no_hann_window),
            floor_db=float(args.floor_db),
            f_min_hz=float(args.f_min_hz),
            f_max_hz=float(args.f_max_hz),
            dynamic_range_db=None if dyn <= 0.0 else dyn,
        )
        results = an.spectrogram.analyse_spectrogram_from_wav_file(path, settings, device=device)
        text = an.spectrogram.summarise_spectrogram_results_text(results)
        render = partial(
            an.spectrogram.render_spectrogram_plots, results, settings,
            an.spectrogram.SpectrogramPlotSettings(renderer=str(args.renderer)),
        )
    elif cmd == "diffusion":
        results = an.diffusion.analyse_diffusion_from_wav_file(
            path,
            an.diffusion.DiffusionAnalysisSettings(
                use_mono_downmix_for_stereo=bool(args.use_mono_downmix),
                trim_to_peak=bool(args.trim_to_peak),
                ignore_leading_seconds=float(args.ignore_leading_seconds),
                window_seconds=float(args.window_seconds),
                hop_seconds=float(args.hop_seconds),
                max_lag_milliseconds=float(args.max_lag_milliseconds),
                echo_density_threshold_rms=float(args.echo_density_threshold_rms),
                echo_density_normalise_to_gaussian=bool(args.echo_density_normalise_to_gaussian),
            ),
            device=device,
        )
        text = an.diffusion.summarise_diffusion_results_text(results)
        render = partial(an.diffusion.render_diffusion_plots, results)
    elif cmd == "waterfall":
        settings = an.waterfall.WaterfallAnalysisSettings(
            use_mono_downmix_for_stereo=bool(args.use_mono_downmix),
            trim_to_peak=bool(args.trim_to_peak),
            ignore_leading_seconds=float(args.ignore_leading_seconds),
            analysis_duration_seconds=args.analysis_duration_seconds,
            n_fft=int(args.n_fft),
            hop_length=int(args.hop_length),
            use_hann_window=not bool(args.no_hann_window),
            f_min_hz=float(args.f_min_hz),
            f_max_hz=float(args.f_max_hz),
            slice_mode=str(args.slice_mode),
            num_slices=int(args.num_slices),
            slice_spacing_seconds=float(args.slice_spacing_seconds),
            start_time_seconds=float(args.start_time_seconds),
            end_time_seconds=args.end_time_seconds,
            db_reference=str(args.db_reference),
            smoothing_log_bins=int(args.smoothing_log_bins),
            log_bins_per_octave=int(args.log_bins_per_octave),
            dynamic_range_db=float(args.dynamic_range_db),
            floor_db=float(args.floor_db),
        )
        results = an.waterfall.analyse_waterfall_from_wav_file(path, settings, device=device)
        text = an.waterfall.summarise_waterfall_results_text(results)
        render = partial(
            an.waterfall.render_waterfall_plots, results, settings,
            an.waterfall.WaterfallPlotSettings(
                style=str(args.style),
                elev_deg=float(args.elev_deg),
                azim_deg=float(args.azim_deg),
                ridge_offset_db=float(args.ridge_offset_db),
            ),
        )
    else:  # modalcloud
        settings = an.modalcloud.ModalCloudAnalysisSettings(
            use_mono_downmix_for_stereo=bool(args.use_mono_downmix),
            trim_to_peak=bool(args.trim_to_peak),
            ignore_leading_seconds=float(args.ignore_leading_seconds),
            analysis_duration_seconds=args.analysis_duration_seconds,
            n_fft=int(args.n_fft),
            hop_length=int(args.hop_length),
            use_hann_window=not bool(args.no_hann_window),
            f_min_hz=float(args.f_min_hz),
            f_max_hz=float(args.f_max_hz),
            log_bins_per_octave=int(args.log_bins_per_octave),
            min_bins=int(args.min_bins),
            metric=str(args.metric),
            fit_lower_limit_db=float(args.fit_lower_limit_db),
            min_fit_points=int(args.min_fit_points),
            min_peak_db_above_floor=float(args.min_peak_db_above_floor),
            floor_db=float(args.floor_db),
        )
        results = an.modalcloud.analyse_modal_cloud_from_wav_file(path, settings, device=device)
        text = an.modalcloud.summarise_modal_cloud_results_text(results)
        ylim = None
        if args.ylim_seconds_min is not None and args.ylim_seconds_max is not None:
            ylim = (float(args.ylim_seconds_min), float(args.ylim_seconds_max))
        render = partial(
            an.modalcloud.render_modal_cloud_plots, results, settings,
            an.modalcloud.ModalCloudPlotSettings(
                show_median_curve=bool(args.show_median_curve),
                median_octave_window=float(args.median_octave_window),
                ylim_seconds=ylim,
            ),
        )
    if figures:
        render(out, show, path)
    _maybe_write_json(args, results)
    print(text)


if __name__ == "__main__":
    main()
