"""
Shared glue of the per-file analyses (audio_analysis_tpu/analyses/_common.py).

Signals are zero-padded to a power-of-two bucket of at least MIN_BUCKET
samples, with the true lengths alongside (see ops.common). `FileDsp` is
one file's device context: every channel rides the batch dim of one
tensor on an explicit device, uploaded once, and the alignment and STFT
results (device tensors and their host copies) are memoised per key, so
analyses that share a key share the work.

Host copies are one device-to-host copy per result: `fetch_packed` packs
several small tensors into one float64 vector, and dB planes cross as the
1/128-dB int16 fixed point of ops.display, which the summaries depend on.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from audio_analysis_tpu_torch.io.wav import get_analysis_channels, load_wav_file
from audio_analysis_tpu_torch.ops import display
from audio_analysis_tpu_torch.ops import stft as stft_ops
from audio_analysis_tpu_torch.ops import trim as trim_ops
from audio_analysis_tpu_torch.ops.common import next_pow2

MIN_BUCKET = 4096

TrimKey = Tuple[bool, float, Optional[float]]


def pad_to_bucket(samples: np.ndarray, device: "str | torch.device" = "cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """(N,) float -> ((1, N_pad) tensor, (1,) int32 length) on `device`,
    N_pad = next_pow2(N) (>= MIN_BUCKET)."""
    x = np.asarray(samples, dtype=np.float32)
    n = x.shape[-1]
    padded = np.zeros((1, max(MIN_BUCKET, next_pow2(n))), np.float32)
    padded[0, :n] = x
    return (
        torch.from_numpy(padded).to(device),
        torch.tensor([n], dtype=torch.int32, device=device),
    )


def fetch_packed(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Several small device tensors in one device-to-host copy (packed as
    float64, which holds float32, int32 and bool values exactly), each
    returned with its own shape and dtype."""
    packed = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()
    out, offset = [], 0
    for t in tensors:
        size = t.numel()
        chunk = packed[offset : offset + size].reshape(tuple(t.shape))
        if t.dtype == torch.bool:
            chunk = chunk > 0.5
        else:
            chunk = chunk.astype(str(t.dtype).replace("torch.", ""))
        out.append(chunk)
        offset += size
    return out


def fetch_db_plane_i16(mag_db: torch.Tensor) -> np.ndarray:
    """A device dB plane on the host as float32, through the 1/128-dB
    int16 fixed point (exact to +-1/256 dB)."""
    return display.dequantize_db_i16(display.quantize_db_i16(mag_db).cpu().numpy())


def load_channels(
    input_wav_file_path: str | Path,
    use_mono_downmix_for_stereo: bool,
) -> Tuple[List[Tuple[str, np.ndarray]], int]:
    """The load policy of every analysis module: mono or stereo, no upmix."""
    loaded = load_wav_file(
        input_wav_file_path,
        expected_channel_mode="mono_or_stereo",
        allow_mono_and_upmix_to_stereo=False,
    )
    return get_analysis_channels(loaded, use_mono_downmix_for_stereo), loaded.sample_rate_hz


def suffixed_png(output_basename: str | Path, suffix: str) -> Path:
    """<basename><suffix>.png next to the basename (the PNG suffix contract)."""
    base = Path(output_basename)
    return base.with_name(f"{base.stem}{suffix}.png")


class FileDsp:
    """
    One file's channels on a torch device.

    - The padded (C, N_pad) signal is uploaded once.
    - `aligned(...)` memoises the trim / ignore / duration alignment per
      knob set, `aligned_host_meta(...)` its host (starts, lengths).
    - `stft_db(...)` memoises the dB STFT per (alignment, n_fft, hop,
      window, floor), `stft_db_host(...)` its host plane.
    """

    def __init__(
        self,
        channels: List[Tuple[str, np.ndarray]],
        sample_rate_hz: int,
        device: "str | torch.device" = "cuda",
    ):
        if not channels:
            raise ValueError("FileDsp needs at least one channel.")
        self.device = torch.device(device)
        self.channel_names: List[str] = [name for name, _ in channels]
        self.host_channels: List[np.ndarray] = [np.asarray(x, dtype=np.float32) for _, x in channels]
        self.sample_rate_hz = int(sample_rate_hz)

        n_max = max(x.shape[-1] for x in self.host_channels)
        stacked = np.zeros((len(self.host_channels), max(MIN_BUCKET, next_pow2(n_max))), np.float32)
        for i, x in enumerate(self.host_channels):
            stacked[i, : x.shape[-1]] = x
        self.x = torch.from_numpy(stacked).to(self.device)  # (C, N_pad)
        self.lengths = torch.tensor(
            [x.shape[-1] for x in self.host_channels], dtype=torch.int32, device=self.device
        )

        self._aligned: Dict[TrimKey, trim_ops.AlignedSignal] = {}
        self._aligned_host: Dict[TrimKey, Tuple[np.ndarray, np.ndarray]] = {}
        self._stft: Dict[tuple, stft_ops.StftResult] = {}
        self._stft_host: Dict[tuple, Tuple[np.ndarray, np.ndarray]] = {}

    @classmethod
    def from_wav_file(
        cls,
        input_wav_file_path: str | Path,
        use_mono_downmix_for_stereo: bool,
        device: "str | torch.device" = "cuda",
    ) -> "FileDsp":
        channels, sr = load_channels(input_wav_file_path, use_mono_downmix_for_stereo)
        return cls(channels, sr, device)

    @property
    def num_channels(self) -> int:
        return len(self.channel_names)

    @property
    def bucket_samples(self) -> int:
        return int(self.x.shape[-1])

    @staticmethod
    def _trim_key(
        trim_to_peak: bool,
        ignore_leading_seconds: float,
        analysis_duration_seconds: Optional[float],
    ) -> TrimKey:
        return (
            bool(trim_to_peak),
            float(ignore_leading_seconds),
            None if analysis_duration_seconds is None else float(analysis_duration_seconds),
        )

    def aligned(
        self,
        trim_to_peak: bool,
        ignore_leading_seconds: float,
        analysis_duration_seconds: Optional[float] = None,
    ) -> trim_ops.AlignedSignal:
        key = self._trim_key(trim_to_peak, ignore_leading_seconds, analysis_duration_seconds)
        if key not in self._aligned:
            self._aligned[key] = trim_ops.align_for_analysis(
                self.x, self.lengths, self.sample_rate_hz, key[0], key[1], key[2]
            )
        return self._aligned[key]

    def aligned_host_meta(
        self,
        trim_to_peak: bool,
        ignore_leading_seconds: float,
        analysis_duration_seconds: Optional[float] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(start_indices (C,), segment_lengths (C,)) as host int64 arrays."""
        key = self._trim_key(trim_to_peak, ignore_leading_seconds, analysis_duration_seconds)
        if key not in self._aligned_host:
            a = self.aligned(*key)
            starts, lengths = fetch_packed(a.start_index, a.length)
            self._aligned_host[key] = (starts.astype(np.int64), lengths.astype(np.int64))
        return self._aligned_host[key]

    def stft_db(
        self,
        trim_to_peak: bool,
        ignore_leading_seconds: float,
        analysis_duration_seconds: Optional[float],
        n_fft: int,
        hop_length: int,
        use_hann_window: bool,
        floor_db: float,
    ) -> stft_ops.StftResult:
        tkey = self._trim_key(trim_to_peak, ignore_leading_seconds, analysis_duration_seconds)
        key = (tkey, int(n_fft), int(hop_length), bool(use_hann_window), float(floor_db))
        if key not in self._stft:
            a = self.aligned(*tkey)
            self._stft[key] = stft_ops.stft_mag_db(a.samples, a.length, *key[1:])
        return self._stft[key]

    def stft_db_host(
        self,
        trim_to_peak: bool,
        ignore_leading_seconds: float,
        analysis_duration_seconds: Optional[float],
        n_fft: int,
        hop_length: int,
        use_hann_window: bool,
        floor_db: float,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(mag_db (C, T, F) in the 1/128-dB fixed point, num_frames (C,)):
        the plane in one copy; the frame counts from the host meta, as the
        device counts them."""
        tkey = self._trim_key(trim_to_peak, ignore_leading_seconds, analysis_duration_seconds)
        key = (tkey, int(n_fft), int(hop_length), bool(use_hann_window), float(floor_db))
        if key not in self._stft_host:
            r = self.stft_db(*tkey, *key[1:])
            _, seg_lens = self.aligned_host_meta(*tkey)
            frames = np.array(
                [stft_ops.num_frames_static(int(l), key[1], key[2]) for l in seg_lens], np.int64
            )
            self._stft_host[key] = (fetch_db_plane_i16(r.mag_db), frames)
        return self._stft_host[key]


def host_aligned_segments(
    dsp: FileDsp,
    trim_to_peak: bool,
    ignore_leading_seconds: float,
    analysis_duration_seconds: Optional[float] = None,
) -> Tuple[List[np.ndarray], np.ndarray, np.ndarray]:
    """Per-channel exact-length trimmed segments as float64 host arrays
    (plus starts and lengths)."""
    starts, seg_lens = dsp.aligned_host_meta(
        trim_to_peak, ignore_leading_seconds, analysis_duration_seconds
    )
    segments = [
        np.asarray(ch[int(s) : int(s) + int(l)], np.float64)
        for ch, s, l in zip(dsp.host_channels, starts, seg_lens)
    ]
    return segments, starts, seg_lens


def single_channel_dsp(
    samples: np.ndarray,
    sample_rate_hz: int,
    channel_name: str,
    device: "str | torch.device" = "cuda",
) -> FileDsp:
    """A one-channel FileDsp for the per-channel APIs."""
    samples = np.asarray(samples)
    if samples.ndim != 1:
        raise ValueError(f"expected a 1D mono array for channel '{channel_name}'.")
    return FileDsp([(str(channel_name), samples)], sample_rate_hz, device)
