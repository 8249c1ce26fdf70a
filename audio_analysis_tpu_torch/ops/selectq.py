"""
Exact masked percentiles with numpy's linear interpolation: the contract of
audio_analysis_tpu/ops/selectq.py masked_percentiles (np.nanpercentile over
x[valid], non-finite values excluded like invalid ones, NaN for a row with
no valid element).

A per-row sort with invalid elements set to +inf, then a gather of the
order statistics at floor(r) and ceil(r) for the fractional rank
r = q (n_valid - 1). torch.nanquantile is not used: it refuses inputs above
2^24 elements, and the group-delay plane of one bundle chunk is larger.
The fractions q / 100 are divided in float32 on the host, as the JAX
package's constant folding divides them (torch on a CUDA tensor would
multiply by a rounded reciprocal, one bit off at q = 5), and live on the
device once per (qs, device): the engine step makes no host-to-device
copy, so it can be captured in a CUDA graph.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from audio_analysis_tpu_torch.ops.common import device_cache


@device_cache(maxsize=8)
def _fractions(qs: tuple, device: torch.device) -> torch.Tensor:
    """qs / 100 as a float32 tensor on the device, each an IEEE float32
    division."""
    return torch.from_numpy(np.asarray(qs, np.float32) / np.float32(100.0)).to(device)


def masked_percentiles(x: torch.Tensor, valid: torch.Tensor, qs: tuple) -> torch.Tensor:
    """(..., N) f32 + (..., N) bool -> (..., len(qs)) f32."""
    ok = valid & torch.isfinite(x)
    keys = torch.where(ok, x.to(torch.float32), math.inf)
    ordered = torch.sort(keys, dim=-1).values
    n_valid = ok.sum(dim=-1)

    r = _fractions(tuple(qs), x.device) * torch.clamp(n_valid[..., None] - 1, min=0).to(torch.float32)
    k_lo = torch.floor(r).to(torch.int64)
    k_hi = torch.ceil(r).to(torch.int64)
    frac = r - k_lo.to(torch.float32)

    v_lo = torch.gather(ordered, -1, k_lo)
    v_hi = torch.gather(ordered, -1, k_hi)
    out = v_lo + frac * (v_hi - v_lo)
    return torch.where(n_valid[..., None] > 0, out, math.nan)
