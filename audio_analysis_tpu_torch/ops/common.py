"""
Shared conventions: arrays carry leading batch dims and a static trailing
length N (the padded bucket size); the true sample count travels alongside
as an int32 `length` tensor broadcastable over the batch dims
(audio_analysis_tpu/ops/common.py).
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading

import torch

_held = threading.local()


def device_cache(maxsize: int):
    """`functools.lru_cache` for constants a function uploads to a device
    once. While `holding(into)` is active on this thread (a CUDA graph's
    capture, engine/graphs.py), every value returned is also appended to
    `into`: a graph reads the constant's memory on every replay, so an
    eviction from this cache must not free it under the graph."""

    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args):
            value = cached(*args)
            into = getattr(_held, "into", None)
            if into is not None:
                into.append(value)
            return value

        return call

    return wrap


@contextlib.contextmanager
def holding(into: list):
    """Collect into `into` every `device_cache` value returned on this
    thread inside the block."""
    outer = getattr(_held, "into", None)
    _held.into = into
    try:
        yield
    finally:
        _held.into = outer


def valid_mask(n: int, length: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(..., n) mask: 1 where index < length."""
    return bool_valid_mask(n, length).to(dtype)


def bool_valid_mask(n: int, length: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(n, dtype=torch.int32, device=length.device)
    return idx < length[..., None]


def hann_window_dynamic(n: int, length: torch.Tensor) -> torch.Tensor:
    """
    Symmetric Hann window of runtime length `length` in a static (..., n)
    buffer: w[i] = 0.5 - 0.5 cos(2 pi i / (length - 1)) for i < length, 0
    beyond — np.hanning(length) placed at the buffer start.
    """
    idx = torch.arange(n, dtype=torch.float32, device=length.device)
    denom = torch.clamp(length.to(torch.float32) - 1.0, min=1.0)[..., None]
    w = 0.5 - 0.5 * torch.cos(2.0 * math.pi * idx / denom)
    return torch.where(idx < length[..., None], w, 0.0)


def next_pow2(n: int) -> int:
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


def db_from_magnitude(mag: torch.Tensor, floor_db: float) -> torch.Tensor:
    """20 log10(max(mag, floor))."""
    floor_lin = 10.0 ** (floor_db / 20.0)
    return 20.0 * torch.log10(torch.clamp(mag, min=floor_lin))


def db_from_power(power: torch.Tensor, eps: float) -> torch.Tensor:
    """10 log10(max(power, eps))."""
    return 10.0 * torch.log10(torch.clamp(power, min=eps))


def box_smooth_same(x: torch.Tensor, window: int) -> torch.Tensor:
    """Moving average along the last axis matching np.convolve(x,
    ones(w)/w, mode="same"): out-of-range samples count as zero, and the
    extra tap of an even window sits on the left. Computed, as in the JAX
    package, as a difference of one cumulative sum, but accumulated in
    float64: in float32 the difference of two sums of a 2^20-sample dB
    curve loses up to ulp(sum) / w (0.1-0.3 dB at w = 2)."""
    n = x.shape[-1]
    c = torch.cumsum(x.to(torch.float64), dim=-1)
    c = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)  # c[i] = sum x[:i]
    i = torch.arange(n, device=x.device)
    hi = torch.clamp(i + (window - 1) // 2 + 1, 0, n)  # exclusive
    lo = torch.clamp(i + (window - 1) // 2 + 1 - window, 0, n)
    return ((c.index_select(-1, hi) - c.index_select(-1, lo)) / float(window)).to(x.dtype)


def unwrap(p: torch.Tensor) -> torch.Tensor:
    """np.unwrap / jnp.unwrap along the last axis (period 2 pi, discont pi),
    including the rule that maps a difference of exactly -pi to +pi when the
    raw difference is positive. The cumulative sum of the corrections runs
    in torch's order, so far along the axis the result can differ from
    jnp.unwrap in the last bits of the accumulated phase."""
    period = 2.0 * math.pi
    interval = 0.5 * period
    dd = torch.diff(p, dim=-1)
    ddmod = torch.remainder(dd + interval, period) - interval
    ddmod = torch.where((ddmod == -interval) & (dd > 0), interval, ddmod)
    ph_correct = torch.where(torch.abs(dd) < interval, 0.0, ddmod - dd)
    return torch.cat([p[..., :1], p[..., 1:] + torch.cumsum(ph_correct, dim=-1)], dim=-1)


def nanmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """jnp.nanmax: the max over non-NaN values, NaN where all are NaN."""
    nan = torch.isnan(x)
    best = torch.where(nan, -math.inf, x).amax(dim=dim)
    return torch.where(nan.all(dim=dim), math.nan, best)


def nanmedian(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """jnp.nanmedian: the mean of the two middle values for an even count
    (torch.nanmedian takes the lower one), NaN where all are NaN."""
    return torch.nanquantile(x, 0.5, dim=dim)
