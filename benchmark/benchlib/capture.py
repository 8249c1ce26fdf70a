"""
Inputs of the benchmark, made from the seed: captures of decaying stereo
noise behind a direct impulse, as a recorder writes them (`meta.json` and
`taps/<tap>.wav`, stereo PCM16, every tap the same length; cpp/recorder.hpp's
layout), and the WAV writer that puts them on disk. The content is drawn on
the device in a few large calls and written once; the writer is the
benchmark's own, so that no change to the program moves the inputs.
"""

from __future__ import annotations

import json
import math
import struct
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch


def generator(seed: int, stream: int, device: torch.device) -> torch.Generator:
    """A generator for one input of a run: streams of one seed never meet,
    nor those of two seeds (2 * seed + stream, seed up to 2^62)."""
    g = torch.Generator(device=device)
    g.manual_seed((2 * int(seed) + int(stream)) % (1 << 63))
    return g


def decaying_taps(seed: int, stream: int, taps: int, channels: int, samples: int, sample_rate_hz: int,
                  content: dict, device) -> Dict[str, torch.Tensor]:
    """(taps, channels, samples) int16 on `device`, and the drawn parameters.

    Each tap: a direct impulse of `impulse` full scale at a drawn delay in
    both channels, then independent Gaussian noise of `noise` rms per
    channel under an exponential envelope that falls 60 dB in T60 seconds.
    T60 is log-uniform over `t60_s`, drawn stratified (one value in each of
    `taps` equal slices of the log range, in a drawn order), so that every
    seed runs the same spread of decays and only their order and fine
    values move. Scaled by 32767 and truncated, as the recorder writes."""
    device = torch.device(device)
    g = generator(seed, stream, device)
    lo, hi = (math.log(v) for v in content["t60_s"])
    u = torch.rand(taps, generator=g, device=device, dtype=torch.float64)
    order = torch.randperm(taps, generator=g, device=device)
    t60 = torch.exp(lo + (order.to(torch.float64) + u) / taps * (hi - lo))
    d_lo, d_hi = content["delay_samples"]
    delay = torch.randint(d_lo, d_hi, (taps,), generator=g, device=device)
    out = torch.empty((taps, channels, samples), dtype=torch.int16, device=device)
    n = torch.arange(samples, device=device, dtype=torch.float32)
    block = max(1, int(content.get("block_taps", 16)))
    for b0 in range(0, taps, block):
        b1 = min(taps, b0 + block)
        noise = torch.randn((b1 - b0, channels, samples), generator=g, device=device, dtype=torch.float32)
        rel = n[None, :] - delay[b0:b1, None].to(torch.float32)
        decay = (-3.0 / (t60[b0:b1, None] * sample_rate_hz)).to(torch.float32)
        env = torch.where(rel >= 0, torch.pow(10.0, decay * rel), 0.0)
        x = float(content["noise"]) * noise * env[:, None, :]
        x.scatter_(-1, delay[b0:b1, None, None].expand(b1 - b0, channels, 1),
                   torch.full((b1 - b0, channels, 1), float(content["impulse"]), device=device))
        out[b0:b1] = (torch.clamp(x, -1.0, 1.0) * 32767.0).to(torch.int16)
        del noise, rel, env, x
    return {"samples": out, "t60_s": t60, "delay": delay}


def wav_bytes_header(frames: int, channels: int, sample_rate_hz: int) -> bytes:
    """The 44-byte RIFF header of a plain PCM16 WAV."""
    data = frames * channels * 2
    return (b"RIFF" + struct.pack("<I", 36 + data) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, sample_rate_hz,
                                    sample_rate_hz * channels * 2, channels * 2, 16)
            + b"data" + struct.pack("<I", data))


def write_wav(path: Path, samples_cn: np.ndarray, sample_rate_hz: int) -> None:
    """(channels, frames) int16 as an interleaved PCM16 WAV."""
    path.parent.mkdir(parents=True, exist_ok=True)
    inter = np.ascontiguousarray(np.asarray(samples_cn, np.int16).T)
    with open(path, "wb") as f:
        f.write(wav_bytes_header(inter.shape[0], inter.shape[1], sample_rate_hz))
        f.write(inter.astype("<i2", copy=False).tobytes())


def tap_names(taps: int) -> List[str]:
    return [f"tap{i:02d}" for i in range(taps)]


def write_capture(root: Path, samples_i16: torch.Tensor, sample_rate_hz: int) -> List[Path]:
    """A capture bundle at `root`: meta.json and one WAV per tap. Returns
    the tap paths."""
    host = samples_i16.cpu().numpy()
    names = tap_names(host.shape[0])
    paths = []
    for name, tap in zip(names, host):
        p = root / "taps" / f"{name}.wav"
        write_wav(p, tap, sample_rate_hz)
        paths.append(p)
    meta = {"sample_rate_hz": int(sample_rate_hz), "length_samples": int(host.shape[-1]), "taps": names}
    (root / "meta.json").write_text(json.dumps(meta, indent=2) + "\n")
    return paths
