"""
Host-side WAV and bundle I/O, reused by import from audio_analysis_tpu.io:
that package is numpy plus a ctypes-bound C++ decoder (cpp/audioio.cpp)
and loads no JAX.
"""

from audio_analysis_tpu.io import native  # noqa: F401
from audio_analysis_tpu.io.bundle import (  # noqa: F401
    load_bundle_batch,
    load_bundle_batch_i16,
    open_bundle_chunks_i16,
    read_bundle_meta,
    write_bundle,
)
