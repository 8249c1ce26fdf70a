"""
WAV reading and writing for the bundle path, in the canonical float32
(num_samples, num_channels) representation in [-1, 1]: int16 scaled by
1/32768, int32 by 1/2^31, uint8 centred at 128, floats clipped. Decodes
with the native library (io.native) when it is built, with
scipy.io.wavfile otherwise.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

import numpy as np

from audio_analysis_tpu_torch.io import native

DEFAULT_EXPECTED_SAMPLE_RATE_HZ = 48_000

_INT16_SCALE = 32768.0
_INT32_SCALE = 2147483648.0


@dataclass(frozen=True)
class LoadedAudio:
    samples: np.ndarray  # (num_samples, num_channels) float32 in [-1, 1]
    sample_rate_hz: int
    file_path: Path


def convert_wav_samples_to_float32(samples_from_wav: np.ndarray) -> np.ndarray:
    """Any supported WAV dtype to float32 in [-1, 1]."""
    dt = samples_from_wav.dtype
    if np.issubdtype(dt, np.floating):
        out = samples_from_wav.astype(np.float32, copy=False)
    elif dt == np.int16:
        out = samples_from_wav.astype(np.float32) / _INT16_SCALE
    elif dt == np.int32:
        out = samples_from_wav.astype(np.float32) / _INT32_SCALE
    elif dt == np.uint8:
        out = (samples_from_wav.astype(np.float32) - 128.0) / 128.0
    elif np.issubdtype(dt, np.integer):
        raise ValueError(f"Unsupported integer PCM dtype: {dt}")
    else:
        raise ValueError(f"Unsupported WAV dtype: {dt}")
    return np.clip(out, -1.0, 1.0).astype(np.float32)


def ensure_2d_channel_array(float_samples: np.ndarray) -> np.ndarray:
    """Shape samples as (num_samples, num_channels)."""
    if float_samples.ndim == 1:
        return float_samples.reshape((-1, 1))
    if float_samples.ndim == 2:
        return float_samples
    raise ValueError(f"Expected 1D or 2D audio array, got shape {float_samples.shape}")


def duplicate_mono_to_stereo(float_samples: np.ndarray) -> np.ndarray:
    """Upmix mono (N,)/(N,1) to stereo (N,2) by channel duplication."""
    x = ensure_2d_channel_array(np.asarray(float_samples))
    if x.shape[1] == 1:
        return np.repeat(x.astype(np.float32), 2, axis=1)
    if x.shape[1] == 2:
        return x.astype(np.float32)
    raise ValueError(f"Expected mono or stereo for upmix, got {x.shape[1]} channels")


def validate_audio_format(loaded_audio: LoadedAudio, expected_sample_rate_hz: int) -> None:
    """Raise ValueError unless the audio is stereo at the expected rate."""
    if loaded_audio.sample_rate_hz != expected_sample_rate_hz:
        raise ValueError(
            f"Expected sample rate {expected_sample_rate_hz} Hz, "
            f"but got {loaded_audio.sample_rate_hz} Hz for file {loaded_audio.file_path}"
        )
    channel_count = loaded_audio.samples.shape[1]
    if channel_count != 2:
        raise ValueError(
            f"Expected stereo (2 channels) but got {channel_count} channels "
            f"for file {loaded_audio.file_path}"
        )


def wav_is_plain_pcm16(path: str | Path) -> bool:
    """Header-only check that a WAV holds plain PCM16 samples, the format
    the native planar-int16 decoder accepts (WAVE_FORMAT_EXTENSIBLE with a
    PCM GUID included). A truncated or garbled header is False."""
    try:
        with open(Path(path), "rb") as f:
            riff = f.read(12)
            if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
                return False
            while True:
                header = f.read(8)
                if len(header) < 8:
                    return False
                chunk_id, chunk_size = header[:4], struct.unpack("<I", header[4:])[0]
                if chunk_id == b"fmt ":
                    if chunk_size < 16 or chunk_size > 65536:
                        return False
                    fmt = f.read(chunk_size)
                    if len(fmt) < 16:
                        return False
                    (format_tag,) = struct.unpack("<H", fmt[:2])
                    (bits,) = struct.unpack("<H", fmt[14:16])
                    if format_tag == 0xFFFE and len(fmt) >= 26:
                        (format_tag,) = struct.unpack("<H", fmt[24:26])
                    return format_tag == 1 and bits == 16
                f.seek(chunk_size + (chunk_size & 1), 1)
    except (OSError, struct.error):
        return False


def wav_header_info(path: str | Path):
    """Header-only (frames, channels, sample_rate) of a RIFF/WAVE file, or
    None when the header cannot be parsed. No PCM data is read: this is the
    probe of io.bundle.materialize_bundle_view on hosts without the native
    decoder."""
    try:
        with open(Path(path), "rb") as f:
            riff = f.read(12)
            if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
                return None
            channels = rate = block_align = None
            while True:
                header = f.read(8)
                if len(header) < 8:
                    return None
                chunk_id, chunk_size = header[:4], struct.unpack("<I", header[4:])[0]
                if chunk_id == b"fmt ":
                    if chunk_size < 16 or chunk_size > 65536:
                        return None
                    fmt = f.read(chunk_size)
                    if len(fmt) < 16:
                        return None
                    channels, rate = struct.unpack("<HI", fmt[2:8])
                    (block_align,) = struct.unpack("<H", fmt[12:14])
                    if chunk_size & 1:
                        f.seek(1, 1)  # RIFF chunks are word-aligned
                elif chunk_id == b"data":
                    if not channels or not rate or not block_align:
                        return None  # data before fmt: malformed
                    return chunk_size // block_align, int(channels), int(rate)
                else:
                    f.seek(chunk_size + (chunk_size & 1), 1)
    except (OSError, struct.error):
        return None


def _read_wav_raw(path: Path) -> Tuple[int, np.ndarray]:
    """(sample_rate_hz, raw samples) of a WAV file, from the native decoder
    when it is built and covers the format, else from scipy."""
    if native.available():
        try:
            return native.read_wav(path)
        except IOError:
            pass  # a format the native decoder does not cover
    from scipy.io import wavfile

    try:
        sample_rate_hz, data = wavfile.read(str(path))
    except (IOError, ValueError):
        raise
    except Exception as exc:
        # scipy raises arbitrary errors on malformed headers
        raise IOError(f"unreadable WAV file {path}: {exc!r}") from exc
    return int(sample_rate_hz), data


def load_wav_file(
    wav_file_path: str | Path, expected_sample_rate_hz: int = DEFAULT_EXPECTED_SAMPLE_RATE_HZ
) -> LoadedAudio:
    """A WAV file as float32 stereo (N, 2), a mono file duplicated to both
    channels; ValueError unless it is stereo at the expected rate."""
    wav_file_path = Path(wav_file_path)
    sample_rate_hz, raw = _read_wav_raw(wav_file_path)
    float_samples = ensure_2d_channel_array(convert_wav_samples_to_float32(raw))
    if float_samples.shape[1] == 1:
        float_samples = duplicate_mono_to_stereo(float_samples)
    loaded = LoadedAudio(
        samples=float_samples.astype(np.float32, copy=False),
        sample_rate_hz=int(sample_rate_hz),
        file_path=wav_file_path,
    )
    validate_audio_format(loaded, expected_sample_rate_hz)
    return loaded


def write_wav_pcm16(output_file_path: str | Path, samples_float32: np.ndarray, sample_rate_hz: int) -> None:
    """Mono (N,)/(N,1) or stereo (N,2) float32 samples as a 16-bit PCM WAV:
    clipped to [-1, 1] and scaled by 32767, truncating."""
    x = np.asarray(samples_float32, dtype=np.float32)
    if x.ndim == 2 and x.shape[1] == 1:
        x = x[:, 0]
    if x.ndim not in (1, 2) or (x.ndim == 2 and x.shape[1] != 2):
        raise ValueError(f"Expected mono (N) or stereo (N,2). Got shape {x.shape}")
    int16_samples = (np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16)
    output_file_path = Path(output_file_path)
    output_file_path.parent.mkdir(parents=True, exist_ok=True)
    if native.available():
        native.write_wav_pcm16(output_file_path, int16_samples, int(sample_rate_hz))
        return
    from scipy.io import wavfile

    wavfile.write(str(output_file_path), int(sample_rate_hz), int16_samples)
