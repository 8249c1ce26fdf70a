"""
Multi-host bundle farms (audio_analysis_tpu/engine/distributed.py): several
processes ("ranks"), on one host or many, over a shared filesystem.

Every rank owns the contiguous block of taps of its local devices in one
global device order (rank 0's devices, then rank 1's, ...), decodes only
those taps, analyses them with the same engine and kernels as a
single-device run, and writes their reports. The per-tap metrics are
all-gathered, so the bundle aggregates are identical on every rank, and
rank 0 writes the index.

The process group is gloo, not NCCL: the collectives move only host data
(the local device counts, per-tap metrics the engine has already fetched,
and a barrier), and NCCL refuses two ranks on one GPU. All device work
stays on each rank's GPU; nothing that runs on the device in the JAX
package runs on the host here.
"""

from __future__ import annotations

import dataclasses
import json
import os
from datetime import timedelta
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from audio_analysis_tpu_torch.engine.batch import analyze_bundle_pipelined
from audio_analysis_tpu_torch.engine.config import EngineConfig
from audio_analysis_tpu_torch.engine.mesh import AGGREGATE_INPUTS, bundle_aggregates, make_mesh
from audio_analysis_tpu_torch.io import ChunkLoader, open_bundle_chunks, read_bundle_meta

DEFAULT_TIMEOUT_S = 600.0


def initialize_multi_host(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """
    Join this process to a multi-host job (a gloo process group over TCP).
    Arguments default to torchrun's environment: MASTER_ADDR and
    MASTER_PORT, WORLD_SIZE, RANK. A collective that waits longer than
    `timeout_s` (a rank died) raises instead of hanging.
    """
    address = coordinator_address
    if not address and os.environ.get("MASTER_ADDR"):
        address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    # NOT `x or env[...]`: process_id=0 (every job's first process) is falsy
    # and must not fall through to the environment
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if not address or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-host job needs a coordinator address, a process count and a process id "
            "(arguments, or MASTER_ADDR/MASTER_PORT, WORLD_SIZE and RANK)"
        )
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{address}",
        world_size=int(num_processes),
        rank=int(process_id),
        timeout=timedelta(seconds=float(timeout_s)),
    )


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device: "str | torch.device" = "cuda") -> torch.device:
    """This rank's device: the bare `cuda` is cuda:(LOCAL_RANK, else the
    rank) modulo the visible CUDA devices; anything else as given."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    visible = torch.cuda.device_count()
    if visible == 0:
        raise RuntimeError("this rank sees no CUDA device")
    local = int(os.environ.get("LOCAL_RANK", process_index()))
    return torch.device("cuda", local % visible)


def _all_gather(obj) -> list:
    """Every rank's `obj`, in rank order."""
    if process_count() == 1:
        gathered = [obj]
    else:
        gathered = [None] * process_count()
        dist.all_gather_object(gathered, obj)
    return gathered


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def analyze_bundle_multi_host(
    bundle_root: str | Path,
    config: Optional[EngineConfig] = None,
    devices: Optional[Sequence] = None,
    pad_multiple: int = 4096,
    gather_global: bool = False,
) -> Dict[str, object]:
    """
    Analyse a bundle across every rank of the job (one process alone when
    no process group is initialised).

    `devices` are this rank's local devices (default: `rank_device()`).
    The bundle is padded to a multiple of the global device count, and
    each device owns a contiguous block of rows, so a rank owns the taps of
    its devices' blocks (padded rows own no tap). Every rank probes every
    tap header (a wrong-rate tap raises the same error everywhere; the
    padded length comes from the headers alone) and runs its own taps
    through the single-host pipeline (`analyze_bundle_pipelined` on its
    devices at the engine report's chunk size, decode and upload
    overlapped with compute) with the engine report's device audio cache,
    so a rerun on an unchanged bundle skips decode and upload.

    Returns per-tap metrics of this rank's taps (row-aligned to
    "local_tap_names"), the bundle aggregates (identical on every rank),
    "num_devices" (the global device count) and, with `gather_global`,
    "global_metrics": every per-tap metric of the whole bundle.
    """
    config = config if config is not None else EngineConfig()
    bundle_root = Path(bundle_root)
    mesh = make_mesh(devices=devices if devices is not None else [rank_device()])
    counts = _all_gather(len(mesh))
    total = sum(counts)
    offset = sum(counts[: process_index()])

    meta, lengths, names, n_max, loader = open_bundle_chunks(bundle_root, pad_multiple)
    if config.sample_rate_hz != meta.sample_rate_hz:
        config = dataclasses.replace(config, sample_rate_hz=meta.sample_rate_hz)
    b = len(names)
    if b == 0:
        raise ValueError(f"Bundle {bundle_root} has no taps.")
    per_dev = _round_up(b, total) // total
    lo, hi = min(b, offset * per_dev), min(b, (offset + len(mesh)) * per_dev)
    local_names = list(names[lo:hi])

    local: Dict[str, np.ndarray] = {}
    if hi > lo:
        from audio_analysis_tpu_torch.report.engine_report import EngineBundleSettings, _device_audio_chunks

        chunk_taps = EngineBundleSettings.chunk_taps
        cache = _device_audio_chunks(bundle_root, local_names, chunk_taps, n_max, mesh[0], mesh)
        local = analyze_bundle_pipelined(
            ChunkLoader(lambda a, z, *out: loader(lo + a, lo + z, *out), loader.channels, loader.interleaved),
            lengths[lo:hi], n_max, config, chunk_taps, mesh=mesh, device_chunk_cache=cache,
        )

    # rank order is tap order: the parts concatenate to the whole bundle
    parts = [p for p in _all_gather({k: v for k, v in local.items() if gather_global or k in AGGREGATE_INPUTS}) if p]
    rows = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    result: Dict[str, object] = dict(local)
    result.update(bundle_aggregates(*(rows[k] for k in AGGREGATE_INPUTS)))
    result["local_tap_names"] = local_names
    result["num_devices"] = total
    if gather_global:
        result["global_metrics"] = rows
    return result


def run_bundle_report_multi_host(
    bundle_root: str | Path,
    config: Optional[EngineConfig] = None,
    reports_subdir: str = "reports",
    compare_to: Optional[str] = None,
    compare_threshold_pct: float = 1.0,
    devices: Optional[Sequence] = None,
) -> Optional[Path]:
    """
    Multi-host engine bundle reports over a shared filesystem: every rank
    writes `<reports>/<tap>/<tap>_report.md` for the taps it owns; after a
    barrier, rank 0 writes the index with the bundle aggregates (and, with
    `compare_to`, the "Changes vs" section) and bundle_metrics.json, and
    returns the index path. Other ranks return None.
    """
    from audio_analysis_tpu_torch.report.compare import compare_section_for_index
    from audio_analysis_tpu_torch.report.engine_report import (
        _channel_names_from_output,
        _summary_context,
        format_tap_summary,
    )

    bundle_root = Path(bundle_root)
    meta = read_bundle_meta(bundle_root)
    sr = meta.sample_rate_hz
    run_config = dataclasses.replace(config if config is not None else EngineConfig(), sample_rate_hz=sr)
    out = analyze_bundle_multi_host(bundle_root, run_config, devices=devices, gather_global=True)
    channel_names = _channel_names_from_output(out["global_metrics"])
    ctx = _summary_context(run_config, sr)

    reports_root = bundle_root / reports_subdir
    reports_root.mkdir(parents=True, exist_ok=True)
    for b, tap in enumerate(out["local_tap_names"]):
        out_dir = reports_root / tap
        out_dir.mkdir(parents=True, exist_ok=True)
        body = format_tap_summary(out, b, channel_names, sr, run_config, ctx)
        header = (
            "# Offline Reverb Analysis Report (engine, multi-host)\n\n"
            f"**Tap:** `{tap}`  \n"
            f"**Analysed by process:** {process_index()}  \n"
            f"**Sample rate:** {sr} Hz\n\n---\n\n"
        )
        (out_dir / f"{tap}_report.md").write_text(header + body)

    # the index must not list reports another rank has not written yet
    if process_count() > 1:
        dist.barrier()
    if process_index() != 0:
        return None

    lines = [
        "# IR Bundle Report (engine, multi-host)\n",
        f"**Bundle:** `{bundle_root}`\n",
        f"**Sample rate:** {meta.sample_rate_hz}\n",
        f"**Taps:** {len(meta.taps)} over {process_count()} process(es) / {out['num_devices']} device(s)\n",
        f"**bundle_median_t30:** {float(out['bundle_median_t30']):.4f} s  \n"
        f"**bundle_mean_early10:** {float(out['bundle_mean_early10']):.4f} s  \n"
        f"**bundle_valid_taps:** {int(out['bundle_valid_taps'])}\n",
        "\n## Taps\n",
    ]
    lines += [f"- [{tap}]({tap}/{tap}_report.md)" for tap in meta.taps]

    metrics_json = {
        "taps": list(meta.taps),
        "channels": channel_names,
        "metrics": {k: np.asarray(v).tolist() for k, v in out["global_metrics"].items()},
    }
    # the previous file is read before this run's dump overwrites it, so an
    # in-place comparison works
    section = (
        compare_section_for_index(metrics_json, compare_to, compare_threshold_pct) if compare_to else None
    )
    (reports_root / "bundle_metrics.json").write_text(json.dumps(metrics_json, indent=1))
    if section:
        lines.append(section)
    index_path = reports_root / "bundle_report.md"
    index_path.write_text("\n".join(lines) + "\n")
    return index_path
