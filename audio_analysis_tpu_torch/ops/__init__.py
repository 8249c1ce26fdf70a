"""
Batched DSP primitives on torch tensors (counterparts of audio_analysis_tpu.ops).

common    validity masks, dynamic Hann window, dB helpers
trim      peak alignment (one gather instead of data-dependent slicing)
edc       Schroeder EDC: plain torch version + the CUDA kernel's wrapper
dbfit     interpolated dB crossings + masked least-squares decay fits
selectq   exact masked percentiles (numpy "linear")
stft      frame STFT magnitude: plain torch version + the CUDA kernel's wrapper
fftmask   raised-cosine FFT filterbank (numpy tables + one batched FFT)
logfreq   modal log-bin tables (numpy)
diffusion sliding-window autocorrelation / echo density / corr0 / IACC
marker    the engine step's block markers (empty kernels a device trace names)

Arrays keep the JAX package's layout: a trailing padded length N with the
valid sample count alongside as an int32 `length` tensor.
"""
