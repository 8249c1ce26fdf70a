"""The fused batched analysis engine, its bundle host entries, the device
mesh (engine.mesh) and the multi-host job (engine.distributed)."""

from audio_analysis_tpu_torch.engine.batch import (  # noqa: F401
    analyze_batch,
    analyze_batch_flat,
    analyze_bundle,
    analyze_bundle_pipelined,
    band_names,
    unpack_flat,
)
from audio_analysis_tpu_torch.engine.config import EngineConfig, config_from_jax  # noqa: F401
from audio_analysis_tpu_torch.engine.distributed import (  # noqa: F401
    analyze_bundle_multi_host,
    initialize_multi_host,
    run_bundle_report_multi_host,
)
from audio_analysis_tpu_torch.engine.mesh import (  # noqa: F401
    analyze_batch_sharded,
    analyze_batch_sharded_flat,
    make_mesh,
)
