"""
WAV reading and writing, in the canonical float32 (num_samples,
num_channels) representation in [-1, 1]: int16 scaled by 1/32768, int32 by
1/2^31, uint8 centred at 128, floats clipped. Decodes with the native
library (io.native) when it is built, with scipy.io.wavfile otherwise.
Channel policy "mono" | "stereo" | "mono_or_stereo" with an optional
mono-to-stereo upmix; analysis channels are "left"/"right", or "mono" for
a mono file or the 0.5 (L + R) downmix (audio_analysis_tpu/io/wav.py).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import List, Literal, Tuple

import numpy as np

from audio_analysis_tpu_torch.io import native

ChannelMode = Literal["mono", "stereo", "mono_or_stereo"]
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


def downmix_to_mono(float_samples: np.ndarray) -> np.ndarray:
    """Average channels down to mono, returned as (N, 1)."""
    x = ensure_2d_channel_array(np.asarray(float_samples))
    return np.mean(x, axis=1, dtype=np.float32).reshape((-1, 1)).astype(np.float32)


def validate_audio_format(
    loaded_audio: LoadedAudio,
    expected_sample_rate_hz: int = DEFAULT_EXPECTED_SAMPLE_RATE_HZ,
    expected_channel_mode: ChannelMode = "stereo",
) -> None:
    """Raise ValueError with an explicit message on any format mismatch."""
    if loaded_audio.sample_rate_hz != expected_sample_rate_hz:
        raise ValueError(
            f"Expected sample rate {expected_sample_rate_hz} Hz, "
            f"but got {loaded_audio.sample_rate_hz} Hz for file {loaded_audio.file_path}"
        )
    channel_count = loaded_audio.samples.shape[1]
    if expected_channel_mode == "mono" and channel_count != 1:
        raise ValueError(
            f"Expected mono (1 channel) but got {channel_count} channels "
            f"for file {loaded_audio.file_path}"
        )
    if expected_channel_mode == "stereo" and channel_count != 2:
        raise ValueError(
            f"Expected stereo (2 channels) but got {channel_count} channels "
            f"for file {loaded_audio.file_path}"
        )
    if expected_channel_mode == "mono_or_stereo" and channel_count not in (1, 2):
        raise ValueError(
            f"Expected mono or stereo (1 or 2 channels) but got {channel_count} "
            f"channels for file {loaded_audio.file_path}"
        )


def read_wav_header_info(path: str | Path) -> Tuple[int, int, int]:
    """(frames, channels, sample_rate_hz) from the RIFF header only, no
    sample decode; ValueError on a header it cannot parse."""
    path = Path(path)
    with open(path, "rb") as f:
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"Not a RIFF/WAVE file: {path}")
        channels = sample_rate = bits = 0
        frames = None
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            chunk_id, chunk_size = header[:4], struct.unpack("<I", header[4:])[0]
            if chunk_id == b"fmt ":
                if chunk_size < 16 or chunk_size > 65536:
                    raise ValueError(f"Malformed fmt chunk in {path}")
                fmt = f.read(chunk_size)
                if chunk_size & 1:
                    f.seek(1, 1)  # RIFF pad byte
                _, channels, sample_rate = struct.unpack("<HHI", fmt[:8])
                bits = struct.unpack("<H", fmt[14:16])[0]
            elif chunk_id == b"data":
                if channels == 0 or bits == 0:
                    raise ValueError(f"data chunk before fmt in {path}")
                frames = chunk_size // (channels * (bits // 8))
                break
            else:
                f.seek(chunk_size + (chunk_size & 1), 1)
        if frames is None:
            raise ValueError(f"No data chunk found in {path}")
        return int(frames), int(channels), int(sample_rate)


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


# (str(path), st_mtime_ns) -> (sample_rate_hz, raw samples) of the last
# _RAW_CACHE_MAX files decoded, oldest first
_RAW_CACHE: dict = {}
_RAW_CACHE_MAX = 4


def _read_wav_raw(path: Path) -> Tuple[int, np.ndarray]:
    """(sample_rate_hz, raw samples) of a WAV file, from the native decoder
    when it is built and covers the format, else from scipy.

    A report opens its input once per analysis (the header, the analyses'
    channels, the IR views): a small mtime-keyed cache decodes it once. A
    rewritten file has a new mtime and is decoded again; errors are not
    cached. Every caller gets the same array and must not write to it."""
    key = (str(path), path.stat().st_mtime_ns)
    if key in _RAW_CACHE:
        return _RAW_CACHE[key]

    result = None
    if native.available():
        try:
            result = native.read_wav(path)
        except IOError:
            pass  # a format the native decoder does not cover
    if result is None:
        from scipy.io import wavfile

        try:
            sample_rate_hz, data = wavfile.read(str(path))
        except (IOError, ValueError):
            raise
        except Exception as exc:
            # scipy raises arbitrary errors on malformed headers
            raise IOError(f"unreadable WAV file {path}: {exc!r}") from exc
        result = (int(sample_rate_hz), data)

    if len(_RAW_CACHE) >= _RAW_CACHE_MAX:
        _RAW_CACHE.pop(next(iter(_RAW_CACHE)))
    _RAW_CACHE[key] = result
    return result


def load_wav_file(
    wav_file_path: str | Path,
    expected_sample_rate_hz: int = DEFAULT_EXPECTED_SAMPLE_RATE_HZ,
    expected_channel_mode: ChannelMode = "stereo",
    allow_mono_and_upmix_to_stereo: bool = True,
) -> LoadedAudio:
    """A WAV file as float32 (N, C), a mono file duplicated to both
    channels where stereo is expected and the upmix allowed; ValueError
    unless it has the expected rate and channel mode."""
    wav_file_path = Path(wav_file_path)
    sample_rate_hz, raw = _read_wav_raw(wav_file_path)
    float_samples = ensure_2d_channel_array(convert_wav_samples_to_float32(raw))
    if (
        expected_channel_mode == "stereo"
        and allow_mono_and_upmix_to_stereo
        and float_samples.shape[1] == 1
    ):
        float_samples = duplicate_mono_to_stereo(float_samples)
    loaded = LoadedAudio(
        samples=float_samples.astype(np.float32, copy=False),
        sample_rate_hz=int(sample_rate_hz),
        file_path=wav_file_path,
    )
    validate_audio_format(loaded, expected_sample_rate_hz, expected_channel_mode)
    return loaded


def get_analysis_channels(
    loaded_audio: LoadedAudio,
    use_mono_downmix_for_stereo: bool = False,
) -> List[Tuple[str, np.ndarray]]:
    """
    Channels to analyse as (name, 1D float32 samples): mono input ->
    [("mono", x)]; stereo -> [("left", L), ("right", R)], or
    [("mono", 0.5 (L + R))] when downmixing.
    """
    channel_count = loaded_audio.samples.shape[1]
    if channel_count == 1:
        return [("mono", loaded_audio.samples[:, 0].astype(np.float32, copy=False))]
    if channel_count == 2:
        left = loaded_audio.samples[:, 0].astype(np.float32, copy=False)
        right = loaded_audio.samples[:, 1].astype(np.float32, copy=False)
        if use_mono_downmix_for_stereo:
            return [("mono", (0.5 * (left + right)).astype(np.float32))]
        return [("left", left), ("right", right)]
    raise ValueError(f"Unsupported channel count: {channel_count}")


def get_channel(loaded_audio: LoadedAudio, channel_index: int) -> np.ndarray:
    """One channel as a 1D float32 array."""
    channel_count = loaded_audio.samples.shape[1]
    if not (0 <= channel_index < channel_count):
        raise ValueError(
            f"channel_index out of range: {channel_index} for {channel_count} channels"
        )
    return loaded_audio.samples[:, channel_index].astype(np.float32, copy=False)


def get_left_right(loaded_audio: LoadedAudio) -> Tuple[np.ndarray, np.ndarray]:
    """(left, right) 1D arrays; the input must be stereo."""
    validate_audio_format(
        loaded_audio,
        expected_sample_rate_hz=loaded_audio.sample_rate_hz,
        expected_channel_mode="stereo",
    )
    return get_channel(loaded_audio, 0), get_channel(loaded_audio, 1)


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


def write_wav_float32(output_file_path: str | Path, samples_2d: np.ndarray, sample_rate_hz: int) -> None:
    """A float32 (IEEE float) WAV of (N, C) samples, written by scipy."""
    output_file_path = Path(output_file_path)
    output_file_path.parent.mkdir(parents=True, exist_ok=True)
    from scipy.io import wavfile

    wavfile.write(str(output_file_path), int(sample_rate_hz), np.asarray(samples_2d, dtype=np.float32))
