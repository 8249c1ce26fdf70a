"""Host-side WAV and bundle I/O of the port: numpy, scipy, and a ctypes
binding of the repo's C++ decoder (cpp/audioio.cpp). No torch, no jax."""

from audio_analysis_tpu_torch.io import native  # noqa: F401
from audio_analysis_tpu_torch.io.bundle import (  # noqa: F401
    BundleMeta,
    load_bundle_batch,
    load_bundle_batch_i16,
    materialize_bundle_view,
    open_bundle_chunks,
    open_bundle_chunks_i16,
    read_bundle_meta,
    write_bundle,
)
