"""
The port's analyse CLI: the engine-path subcommands of
audio_analysis_tpu/cli/analyse_cli.py with the same flags, defaults,
messages and exit codes.

    python -m audio_analysis_tpu_torch.cli bundle --input <root> --no-plots [--compare PREV --fail-on-change]
    python -m audio_analysis_tpu_torch.cli batch --inputs a.wav b.wav --output <dir> --no-plots
    python -m audio_analysis_tpu_torch.cli watch --input <recorder output dir>
    python -m audio_analysis_tpu_torch.cli compare <previous run> <current run>

`--device` picks the torch device (default cuda; `--device cpu` runs the
plain torch versions of the kernels on the host). Without CUDA, a command
that touches the device exits at once unless `--device cpu` is given.
Flags of the JAX CLI whose paths are not ported yet are refused with a
"not yet ported" exit.
"""

from __future__ import annotations

import argparse
from dataclasses import replace
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
                   help="Skip taps whose report already exists (plot reports: not yet "
                        "ported).")
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true",
                   help="Downmix stereo to mono in every tap report.")
    p.add_argument("--no-plots", dest="no_plots", action="store_true",
                   help="Engine fast path: text/JSON metric reports only (required: the "
                        "plot reports are not yet ported).")
    p.add_argument("--bands", dest="band_mode", type=str, default="three",
                   choices=["three", "octave", "third"],
                   help="RT60 band mode (rt60bands.py band modes).")
    _add_engine_config_flags(p)
    p.add_argument("--plot-processes", dest="plot_processes", type=int, default=0,
                   help="Plot render processes (not yet ported).")
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
                   help="Shard the plot bundle (not yet ported).")
    p.add_argument("--multi-host", dest="multi_host", action="store_true",
                   help="Multi-host engine path (not yet ported).")
    p.add_argument("--coordinator", dest="coordinator", type=str, default=None,
                   help="Coordinator of --multi-host (not yet ported).")
    p.add_argument("--num-processes", dest="num_processes", type=int, default=None)
    p.add_argument("--process-id", dest="process_id", type=int, default=None)
    _add_device(p)

    # --- batch (loose WAV files through the bundle tooling) ---
    p = sub.add_parser(
        "batch",
        help="Analyse a set of loose WAV files as one batch: materialises a "
             "bundle view (meta.json + tap symlinks) in --output, then runs "
             "the engine bundle path over it (--no-plots).",
    )
    p.add_argument("--inputs", dest="input_wav_paths", type=str, nargs="+", required=True,
                   help="WAV files to analyse (shell globs expand naturally).")
    p.add_argument("--output", dest="bundle_root", type=str, required=True,
                   help="Directory for the bundle view + reports (created).")
    p.add_argument("--reports-subdir", dest="reports_subdir", type=str, default="reports")
    p.add_argument("--resume", action="store_true",
                   help="Skip files whose plot report already exists (not yet ported).")
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true")
    p.add_argument("--no-plots", dest="no_plots", action="store_true",
                   help="Engine fast path: text/JSON metric reports only (required).")
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
                   help="Also render the plot report per bundle (not yet ported).")
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
    return top


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


def _not_yet_ported(cmd: str, args: argparse.Namespace) -> Optional[str]:
    """The first flag (or path) of `cmd` that the port does not have yet."""
    refused = (
        ("--multi-host", getattr(args, "multi_host", False)),
        ("--coordinator", getattr(args, "coordinator", None) is not None),
        ("--num-processes", getattr(args, "num_processes", None) is not None),
        ("--process-id", getattr(args, "process_id", None) is not None),
        ("--tap-shard", getattr(args, "tap_shard", None) is not None),
        ("--resume", getattr(args, "resume", False)),
        ("--plots", getattr(args, "watch_plots", False)),
        ("--plot-processes", bool(getattr(args, "plot_processes", 0))),
    )
    for flag, given in refused:
        if given:
            return flag
    if cmd in ("bundle", "batch") and not args.no_plots:
        return f"{cmd} without --no-plots (the plot reports)"
    return None


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
    missing = _not_yet_ported(cmd, args)
    if missing is not None:
        raise SystemExit(f"analyse {cmd}: {missing} is not yet ported to audio_analysis_tpu_torch")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"analyse {cmd}: CUDA is not available; pass --device cpu to run the "
            "plain torch versions on the host"
        )

    if cmd == "watch":
        from audio_analysis_tpu_torch.report.watch import WatchSettings, watch_bundle_runs

        watch_settings = WatchSettings(
            poll_seconds=float(args.poll_seconds),
            engine=_engine_settings(args),
            compare_to_previous=not bool(args.no_compare),
            compare_threshold_pct=float(args.compare_threshold),
            max_bundles=args.max_bundles,
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


if __name__ == "__main__":
    main()
