"""Draw spaces and limits shared by tests/test_torch_fuzz_rest.py (the port
against the JAX package on the CPU) and chip_smoke.py's fuzz phase (the
card against the CPU). Plain data: no jax, no torch.

- GEN_FLAGS: every flag of each gen CLI subcommand but --output, with the
  values a draw picks from.
- DECONVOLVE_TOL: the deconvolved IR's limits per regularisation, as
  fractions of the reference's peak: (float32 against float32, against
  float64). The regularised inverse amplifies float32 FFT rounding where
  the sweep has little energy, by up to 1/(2 sqrt(regularisation)) of its
  passband gain. The worst over 216 configurations on the CPU (the golden,
  modal and damped IRs cut to 2048, 8192 and 2^16 samples, mono and
  stereo, both output lengths, with and without the peak normalisation and
  the DC removal) at 1e-8, 1e-10 and 1e-12: 1.3e-5, 5.9e-4 and 1.65e-2
  between the port and the JAX package, 1.1e-5, 4.5e-4 and 1.2e-2 between
  the port and float64 (the JAX package's own: 5.5e-6, 3.3e-4 and 9.3e-3).
  The limits are about 3-4x those.
"""

WINDOWS = ("rect", "hann", "hamming", "blackman")

GEN_FLAGS = {
    "impulse": {"--duration": (0.05, 0.5), "--impulse_sample_index": (0, 7, 100)},
    "click": {"--duration": (0.0005, 0.001, 0.003), "--window_type": WINDOWS},
    "impulse_train": {"--duration": (0.3, 1.0), "--period": (0.05, 0.1, 0.25), "--click-duration": (0.001, 0.003),
                      "--window_type": WINDOWS},
    "noise_long": {"--duration_seconds": (0.2, 0.5), "--noise_type": ("white", "pink"),
                   "--random_seed": (0, 3, 977, 65521)},
    "noise_burst": {"--duration": (0.01, 0.05), "--noise_type": ("white", "pink"), "--random_seed": (0, 5, 61, 4099),
                    "--window_type": WINDOWS},
    "sine_sustain": {"--freq": (55.0, 997.0, 12000.0), "--duration_seconds": (0.2, 0.5),
                     "--amplitude": (0.1, 0.5, 1.0), "--initial_phase_radians": (0.0, 0.5, 3.0)},
    "sine_burst": {"--freq": (110.0, 330.0, 5000.0), "--duration": (0.05, 0.2), "--amplitude": (0.3, 0.9),
                   "--window_type": WINDOWS},
    "sweep": {"--duration_seconds": (0.5, 1.0), "--start-freq": (20.0, 50.0), "--end-freq": (15000.0, 20000.0),
              "--amplitude": (0.5, 0.7), "--fade_duration_seconds": (0.01, 0.02), "--pre_silence_seconds": (0.0, 0.1),
              "--post_silence_seconds": (0.0, 0.2)},
    "pluck": {"--duration_seconds": (0.1, 0.3), "--bandlimit": (3000.0, 8000.0), "--decay": (0.01, 0.05),
              "--random_seed": (0, 2, 4093, 65519)},
    "karplus_pluck": {"--freq": (55.0, 110.0, 440.0, 4000.0), "--duration_seconds": (0.2, 0.5),
                      "--bandlimit": (4000.0, 8000.0), "--feedback_decay_factor": (0.98, 0.996, 0.999),
                      "--lowpass_blend": (0.3, 0.5, 1.0), "--random_seed": (0, 1, 7919, 65497)},
}

DECONVOLVE_TOL = {1e-8: (5e-5, 5e-5), 1e-10: (2e-3, 2e-3), 1e-12: (5e-2, 5e-2)}
