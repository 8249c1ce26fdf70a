"""
Multi-device scaling of the bundle engine (audio_analysis_tpu/engine/mesh.py).

The tap batch is the parallel axis. A mesh is an ordered tuple of
`torch.device`s, the "taps" axis: shard i gets the i-th contiguous block of
taps and runs the same `analyze_batch` as the single-device path, kernels
included, on its own device. Shards are dispatched one after another from
one thread; `analyze_batch` has no host sync before the fetch, so the
cards overlap. The per-shard results come back to the mesh's first device.
On CUDA, `analyze_batch_sharded_flat` runs each shard's step through the
step graphs (engine.graphs): one graph per device, shared by the shards on
that device, replayed one after another.

The JAX mesh swaps both Pallas kernels for jnp stand-ins under
`shard_map` (Pallas outputs carry no vma metadata there). That is a JAX
limitation, not semantics: every shard here launches K1 and K2.

A device may appear more than once (two shards on one card run in turn),
and `make_mesh(n, platform="cpu")` gives n CPU shards that run the plain
torch versions one after another, the counterpart of the JAX tests'
virtual CPU devices. Asking for more CUDA devices than are visible raises:
there is no fallback to the CPU.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from audio_analysis_tpu_torch.engine.batch import analyze_batch, analyze_batch_flat
from audio_analysis_tpu_torch.engine.config import EngineConfig

Mesh = Tuple[torch.device, ...]

# the per-tap outputs the bundle aggregates read
AGGREGATE_INPUTS = ("t30_rt60", "t30_ok", "early10_time", "early10_ok")


def make_mesh(
    num_devices: Optional[int] = None,
    platform: Optional[str] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """
    A 1-D "taps" mesh: `devices` as given (a device may repeat), or the
    first `num_devices` visible CUDA devices (every one by default), or
    with platform="cpu" `num_devices` (default 1) CPU shards.
    """
    if devices is not None:
        mesh = tuple(torch.device(d) for d in devices)
        if not mesh or (num_devices is not None and int(num_devices) != len(mesh)):
            raise ValueError(f"a mesh of {num_devices} devices cannot be {list(mesh)}")
        visible = torch.cuda.device_count() if any(d.type == "cuda" for d in mesh) else 0
        for d in mesh:
            if d.type == "cuda" and (d.index is None or d.index >= visible):
                raise ValueError(f"mesh device {d} is not one of the {visible} visible CUDA devices")
        return mesh
    platform = (platform or "cuda").lower()
    if platform == "cpu":
        return (torch.device("cpu"),) * int(num_devices or 1)
    if platform != "cuda":
        raise ValueError(f"unknown mesh platform {platform!r} (cuda or cpu)")
    visible = torch.cuda.device_count()
    wanted = visible if num_devices is None else int(num_devices)
    if wanted < 1 or wanted > visible:
        raise ValueError(f"Requested {wanted} CUDA devices but only {visible} are visible")
    return tuple(torch.device("cuda", i) for i in range(wanted))


def _on_device(device: torch.device):
    """`torch.cuda.device(device)` for a CUDA device, else a no-op."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _pad_to_multiple(batch: np.ndarray, lengths: np.ndarray, multiple: int):
    """Pad the tap axis to a multiple by repeating tap 0 with its length."""
    b = batch.shape[0]
    pad = (-b) % multiple
    if pad == 0:
        return batch, lengths, 0
    batch = np.concatenate([batch, np.tile(batch[:1], (pad, 1, 1))], axis=0)
    lengths = np.concatenate([lengths, np.tile(lengths[:1], pad)])
    return batch, lengths, pad


def _split(mesh: Mesh, host: np.ndarray) -> Tuple[torch.Tensor, ...]:
    """A host array whose first axis is a multiple of the shard count, cut
    into contiguous blocks, each uploaded to its shard's device."""
    per = host.shape[0] // len(mesh)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(host[i * per : (i + 1) * per])).to(d)
        for i, d in enumerate(mesh)
    )


def _sharded_inputs(mesh: Mesh, batch, lengths):
    """(per-shard samples, per-shard lengths, real tap count). `batch` and
    `lengths` are host arrays ((B, C, N) and (B,), padded here) or
    sequences of per-shard tensors already on their devices (used as they
    are)."""
    if isinstance(batch, (list, tuple)):
        if len(batch) != len(mesh) or len(lengths) != len(mesh):
            raise ValueError(f"{len(batch)} pre-sharded blocks for a mesh of {len(mesh)}")
        return tuple(batch), tuple(lengths), sum(int(x.shape[0]) for x in batch)
    batch = np.asarray(batch)
    if batch.dtype != np.int16:  # int16 travels raw; the engine converts
        batch = batch.astype(np.float32, copy=False)
    padded, lengths_p, _pad = _pad_to_multiple(batch, np.asarray(lengths, np.int32), len(mesh))
    return _split(mesh, padded), _split(mesh, lengths_p), batch.shape[0]


def bundle_aggregates(t30_rt60, t30_ok, early10_time, early10_ok, valid_rows=None) -> Dict[str, np.generic]:
    """Bundle-wide aggregates of per-tap (B, C) arrays on the host, in
    float32 with numpy's semantics (the median of an even count averages
    the two middle values, as jnp.nanmedian does; torch's median takes the
    lower one). Rows where `valid_rows` is False (padding) are left out."""
    t30_ok = np.asarray(t30_ok, bool)
    early10_ok = np.asarray(early10_ok, bool)
    if valid_rows is not None:
        row = np.asarray(valid_rows, bool)[:, None]
        t30_ok, early10_ok = t30_ok & row, early10_ok & row
    t30 = np.where(t30_ok, np.asarray(t30_rt60, np.float32), np.float32(np.nan))
    early = np.where(early10_ok, np.asarray(early10_time, np.float32), np.float32(np.nan))
    with warnings.catch_warnings():  # an all-NaN bundle aggregates to NaN, as in JAX
        warnings.simplefilter("ignore", RuntimeWarning)
        median, mean = np.nanmedian(t30), np.nanmean(early)
    return {
        "bundle_median_t30": np.float32(median),
        "bundle_mean_early10": np.float32(mean),
        "bundle_valid_taps": np.int32(np.any(t30_ok, axis=-1).sum()),
    }


def analyze_batch_sharded(
    mesh: Mesh,
    batch,
    lengths,
    config: EngineConfig = EngineConfig(),
    include_bundle_aggregates: bool = True,
) -> Dict[str, torch.Tensor]:
    """
    The fused engine with the tap batch cut into one contiguous block per
    shard (B padded to a multiple of the shard count by repeating tap 0),
    each block analysed on its device. Per-tap outputs are concatenated on
    the mesh's first device, padded rows trimmed. With
    `include_bundle_aggregates`, also bundle_median_t30,
    bundle_mean_early10 and bundle_valid_taps (0-d CPU tensors, computed on
    the host by `bundle_aggregates`: this fetches the four inputs).
    """
    samples, lens, b = _sharded_inputs(mesh, batch, lengths)
    outs = []
    for d, x, n in zip(mesh, samples, lens):
        with _on_device(d):
            outs.append(analyze_batch(x, n, config))
    home = mesh[0]
    out = {k: torch.cat([o[k].to(home, non_blocking=True) for o in outs])[:b] for k in outs[0]}
    if include_bundle_aggregates:
        host = [out[k].cpu().numpy() for k in AGGREGATE_INPUTS]
        out.update({k: torch.from_numpy(np.asarray(v)) for k, v in bundle_aggregates(*host).items()})
    return out


def analyze_batch_sharded_flat(mesh: Mesh, batch, lengths, config: EngineConfig = EngineConfig(),
                               chunks_ahead: int = 0, interleaved: bool = False):
    """
    A sharded chunk packed into one float32 vector on the mesh's first
    device, laid out exactly like `analyze_batch_flat` of the whole chunk
    (sorted keys, each raveled over every tap), with that layout's spec, so
    `unpack_flat` / `fetch_packed` read it unchanged. Each shard packs its
    own block; the blocks are regrouped key by key after the gather. The
    tap count must be a multiple of the shard count (callers pad); no
    bundle aggregates. `chunks_ahead`: how many more chunks of this shape
    the caller runs right after this one (each shard's step counts the
    calls of its key still to come, engine.graphs). `interleaved`: the
    shards are interleaved (B, N, C) chunks (analyze_batch_flat).
    """
    if not isinstance(batch, (list, tuple)) and np.shape(batch)[0] % len(mesh):
        raise ValueError(f"batch of {np.shape(batch)[0]} taps not divisible by mesh taps={len(mesh)} (pad the chunk)")
    samples, lens, _b = _sharded_inputs(mesh, batch, lengths)
    flats = []
    for i, (d, x, n) in enumerate(zip(mesh, samples, lens)):
        ahead = chunks_ahead * mesh.count(d) + mesh[i + 1:].count(d)
        with _on_device(d):
            flat, spec = analyze_batch_flat(x, n, config, ahead, interleaved)
        flats.append(flat.to(mesh[0], non_blocking=True))
    if len(flats) == 1:
        return flats[0], spec
    sizes = [int(np.prod(shape)) for _key, shape, _dtype in spec]
    pieces = [torch.split(flat, sizes) for flat in flats]
    flat = torch.cat([p[i] for i in range(len(sizes)) for p in pieces])
    spec = [(key, (shape[0] * len(flats),) + tuple(shape[1:]), dtype) for key, shape, dtype in spec]
    return flat, spec
