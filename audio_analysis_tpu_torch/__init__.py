"""
audio_analysis_tpu_torch — the PyTorch/CUDA port of audio_analysis_tpu.

The JAX package stays the reference; this package computes the same
results with torch tensors on an explicit device, and replaces each Pallas
TPU kernel with a hand-written CUDA kernel for Hopper (sm_90a):

  ops/      batched DSP primitives (torch), plus the kernel wrappers
            ops.edc (Schroeder EDC, csrc/edc.cu) and ops.stft (frame STFT
            magnitude, csrc/stft.cu)
  engine/   the fused per-chunk analysis (analyze_batch), the pipelined
            bundle host entry (analyze_bundle_pipelined), the tap batch
            sharded over a mesh of devices (engine.mesh) and the multi-host
            job over a gloo process group (engine.distributed)
  report/   the engine bundle report (per-tap markdown + bundle_metrics.json),
            the run-to-run comparison, the bundle watcher, and the plot
            reports (report.report, report.bundle, report.warmup)
  analyses/ the per-file analyses, their summaries and figures
  plot/     matplotlib helpers (house style, figure templates, display
            decimation), imported only by the figure functions
  parallel/ the render thread and the spawn-based render process pool
  signals/  the test-tone generators (numpy; Karplus-Strong on the device)
  cli/      `python -m audio_analysis_tpu_torch.cli <command>` (the analyse
            CLI) and `python -m audio_analysis_tpu_torch.cli.gen_cli`
  io/       WAV and capture-bundle I/O (numpy, scipy, and a ctypes binding of
            the repo's C++ decoder cpp/audioio.cpp)
  csrc/     CUDA sources, built with nvcc at first use (_build.py)
  oracle/   the float64 NumPy oracle (a copy of the JAX package's): the
            reference's formulas, the ground truth of the tests and of
            chip_smoke.py; numpy only

Nothing here imports jax or the JAX package audio_analysis_tpu; matplotlib
is imported only when a figure is drawn.

Float32 matrix products and convolutions run in full float32: TF32 keeps
about three decimal digits, and low-precision products were measured to
move the modal RT60 fits by a relative 1.5 in the JAX package's precision
study.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
