"""
Exact masked percentiles with numpy's linear interpolation: the contract of
audio_analysis_tpu/ops/selectq.py masked_percentiles (np.nanpercentile over
x[valid], non-finite values excluded like invalid ones, NaN for a row with
no valid element).

A per-row sort with invalid elements set to +inf, then a gather of the
order statistics at floor(r) and ceil(r) for the fractional rank
r = q (n_valid - 1). torch.nanquantile is not used: it refuses inputs above
2^24 elements, and the group-delay plane of one bundle chunk is larger.
"""

from __future__ import annotations

import math

import torch


def masked_percentiles(x: torch.Tensor, valid: torch.Tensor, qs: tuple) -> torch.Tensor:
    """(..., N) f32 + (..., N) bool -> (..., len(qs)) f32."""
    ok = valid & torch.isfinite(x)
    keys = torch.where(ok, x.to(torch.float32), math.inf)
    ordered = torch.sort(keys, dim=-1).values
    n_valid = ok.sum(dim=-1)

    qarr = torch.tensor(qs, dtype=torch.float32, device=x.device) / 100.0
    r = qarr * torch.clamp(n_valid[..., None] - 1, min=0).to(torch.float32)
    k_lo = torch.floor(r).to(torch.int64)
    k_hi = torch.ceil(r).to(torch.int64)
    frac = r - k_lo.to(torch.float32)

    v_lo = torch.gather(ordered, -1, k_lo)
    v_hi = torch.gather(ordered, -1, k_hi)
    out = v_lo + frac * (v_hi - v_lo)
    return torch.where(n_valid[..., None] > 0, out, math.nan)
