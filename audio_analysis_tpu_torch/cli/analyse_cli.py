"""
The port's analyse CLI: the `bundle --no-plots` engine path of
audio_analysis_tpu/cli/analyse_cli.py with the same flags.

    python -m audio_analysis_tpu_torch.cli bundle --input <root> --no-plots

`--device` picks the torch device (default cuda; `--device cpu` runs the
plain torch versions of the kernels on the host). Flags of the JAX CLI
whose paths are not ported yet are refused with a "not yet ported" exit.
"""

from __future__ import annotations

import argparse
from dataclasses import replace
from typing import Optional, Sequence

import torch

from audio_analysis_tpu_torch.engine.config import EngineConfig
from audio_analysis_tpu_torch.report.engine_report import (
    EngineBundleSettings,
    run_bundle_report_engine,
)


def build_parser() -> argparse.ArgumentParser:
    top = argparse.ArgumentParser(
        prog="analyse",
        description="Offline analysis of reverb outputs on a CUDA device (PyTorch port).",
    )
    sub = top.add_subparsers(dest="command_name", required=True)

    p = sub.add_parser("bundle", help="Analyse an IR bundle folder (meta.json + taps/*.wav).")
    p.add_argument("--input", dest="bundle_root", type=str, required=True)
    p.add_argument("--reports-subdir", dest="reports_subdir", type=str, default="reports")
    p.add_argument("--mono", dest="use_mono_downmix", action="store_true",
                   help="Downmix stereo to mono in every tap report.")
    p.add_argument("--no-plots", dest="no_plots", action="store_true",
                   help="Engine fast path: text/JSON metric reports only (required: the "
                        "plot reports are not yet ported).")
    p.add_argument("--bands", dest="band_mode", type=str, default="three",
                   choices=["three", "octave", "third"],
                   help="RT60 band mode (rt60bands.py band modes).")
    p.add_argument("--modal-trim-bins", dest="modal_trim_bins",
                   action=argparse.BooleanOptionalAction, default=None,
                   help="Trim the modal STFT at the last log-bin-weighted rfft bin "
                        "(EngineConfig.modal_trim_bins, default on).")
    p.add_argument("--prefetch-chunks", dest="prefetch_chunks", type=int, default=None,
                   help="Audio chunks decoded + uploaded ahead of the one being computed "
                        "(default 2; 1 = serialized pipeline).")
    p.add_argument("--device", dest="device", type=str, default="cuda",
                   help="torch device to run on (default cuda).")
    # flags of the JAX CLI whose paths are not ported yet: accepted by the
    # parser so that they can be refused with a clear message
    p.add_argument("--bands-decimate", dest="bands_decimate",
                   action=argparse.BooleanOptionalAction, default=None)
    p.add_argument("--compare", dest="compare_to", type=str, default=None, metavar="PREV")
    p.add_argument("--multi-host", dest="multi_host", action="store_true")
    p.add_argument("--tap-shard", dest="tap_shard", type=str, default=None, metavar="I/N")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--plot-processes", dest="plot_processes", type=int, default=0)
    return top


def _not_yet_ported(args: argparse.Namespace) -> Optional[str]:
    if not args.no_plots:
        return "bundle without --no-plots (the plot reports)"
    refused = (
        ("--bands-decimate", bool(args.bands_decimate)),
        ("--compare", args.compare_to is not None),
        ("--multi-host", args.multi_host),
        ("--tap-shard", args.tap_shard is not None),
        ("--resume", args.resume),
        ("--plot-processes", bool(args.plot_processes)),
    )
    for flag, given in refused:
        if given:
            return flag
    return None


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    missing = _not_yet_ported(args)
    if missing is not None:
        raise SystemExit(f"analyse bundle: {missing} is not yet ported to audio_analysis_tpu_torch")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "analyse bundle: CUDA is not available; pass --device cpu to run the "
            "plain torch versions on the host"
        )

    config = replace(EngineConfig(), band_mode=args.band_mode)
    if args.modal_trim_bins is not None:
        config = replace(config, modal_trim_bins=bool(args.modal_trim_bins))
    overrides = {}
    if args.prefetch_chunks is not None:
        overrides["prefetch_chunks"] = max(1, int(args.prefetch_chunks))
    settings = EngineBundleSettings(
        reports_subdir=args.reports_subdir,
        use_mono_downmix_for_stereo=bool(args.use_mono_downmix),
        config=config,
        **overrides,
    )
    index = run_bundle_report_engine(args.bundle_root, settings, device)
    print(f"Wrote bundle report index: {index}")


if __name__ == "__main__":
    main()
