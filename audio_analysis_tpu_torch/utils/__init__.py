"""Host-side helpers of the port (no torch): the JSON of analysis results."""

from audio_analysis_tpu_torch.utils.jsonio import results_to_json, write_results_json  # noqa: F401
