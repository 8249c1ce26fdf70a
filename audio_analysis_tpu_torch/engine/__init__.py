"""The fused batched analysis engine and its bundle host entries."""

from audio_analysis_tpu_torch.engine.batch import (  # noqa: F401
    analyze_batch,
    analyze_batch_flat,
    analyze_bundle,
    analyze_bundle_pipelined,
    band_names,
    unpack_flat,
)
from audio_analysis_tpu_torch.engine.config import EngineConfig, config_from_jax  # noqa: F401
