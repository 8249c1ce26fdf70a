"""Command line entry: `python -m audio_analysis_tpu_torch.cli bundle --input <root> --no-plots`."""
