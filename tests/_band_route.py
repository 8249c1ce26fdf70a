"""The engine's bands block with the band plane aligned first: the route
engine/batch.py `_band_fits` took before the EDC read each band row from
its start, rebuilt with each row aligned by slicing (`sliced_rows`, which
shares no code with ops/trim.py `shift_to`) and `edc.schroeder_edc_db`
without starts. tests/test_torch_ops.py (CPU) and tests/test_torch_cuda.py
(card) hold the engine's band outputs bit-equal to it.
"""

import dataclasses
from unittest import mock

import numpy as np
import torch

from audio_analysis_tpu_torch.engine import EngineConfig, analyze_batch
from audio_analysis_tpu_torch.engine import batch as batch_module
from audio_analysis_tpu_torch.ops import dbfit, edc

BAND_KEYS = tuple(f"band_{fit}_{what}" for fit in ("t30", "t20", "edt") for what in ("rt60", "ok"))
# (band_mode, channels, bands_decimate)
BAND_ROUTES = {
    "three": ("three", 2, False),
    "third_stereo": ("third", 2, False),
    "third_16ch": ("third", 16, False),
    "three_decimate": ("three", 2, True),
    "third_decimate": ("third", 2, True),
}


def sliced_rows(x, start, length):
    """Each row of x (..., N) aligned by slicing: its samples from
    clamp(start, 0, N) over the aligned length max(length - start, 0), at
    index 0 and zeros after; and the aligned lengths (int32)."""
    n = x.shape[-1]
    shape = x.shape[:-1]
    starts = torch.broadcast_to(start, shape).reshape(-1).tolist()
    lengths = torch.broadcast_to(length, shape).reshape(-1).tolist()
    rows = x.reshape(-1, n)
    out = torch.zeros_like(rows)
    kept = []
    for r, (s, l) in enumerate(zip(starts, lengths)):
        keep = max(l - s, 0)
        segment = rows[r, min(max(s, 0), n):][:keep]
        out[r, : segment.shape[0]] = segment
        kept.append(keep)
    return out.reshape(x.shape), torch.tensor(kept, dtype=torch.int32, device=x.device).reshape(shape)


def shifted_band_fits(banded, start, length, factor, config):
    """`_band_fits` with the plane aligned by `sliced_rows` before K1."""
    plane = banded.shape[:-1]
    if factor > 1:
        start, length = start // factor, length // factor
    aligned, aligned_length = sliced_rows(banded, start[..., None].expand(plane), length[..., None].expand(plane))
    del banded
    curve = edc.schroeder_edc_db(aligned, aligned_length, config.edc_epsilon, config.edc_floor_db)
    fits = dbfit.fit_decay_ranges(
        curve.edc_db, curve.length, (config.t30_range_db, config.t20_range_db, config.edt_range_db),
        config.fit_lower_limit_db, config.sample_rate_hz / factor,
    )
    res = {}
    for name, fit in zip(("band_t30", "band_t20", "band_edt"), fits):
        res[f"{name}_rt60"] = fit.rt60_seconds
        res[f"{name}_ok"] = fit.ok
    return res


def route_taps(taps: int, channels: int, n: int, seed: int):
    """(taps, channels, n) decaying noise after a direct impulse at a drawn
    delay (three starts in four not a multiple of 4), and lengths below n."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48_000
    x = np.zeros((taps, channels, n), np.float32)
    lengths = np.array([n - 3072 - 911 * i for i in range(taps)], np.int32)
    for i in range(taps):
        for ch in range(channels):
            delay = int(rng.integers(64, 2048))
            rt60 = float(rng.uniform(0.3, 1.5))
            x[i, ch, delay:] = 0.05 * rng.standard_normal(n - delay) * 10.0 ** (-3.0 * t[: n - delay] / rt60)
            x[i, ch, delay] = 0.9
        x[i, :, lengths[i]:] = 0.0
    return x, lengths


def band_outputs_both_routes(route: str, n: int, device, seed: int = 21):
    """The engine's band outputs on `device`, and the same step with
    `_band_fits` swapped for the shifted route."""
    band_mode, channels, decimate = BAND_ROUTES[route]
    x, lengths = route_taps(2, channels, n, seed)
    cfg = dataclasses.replace(EngineConfig(), band_mode=band_mode, bands_decimate=decimate, run_fr=False,
                              run_group_delay=False, run_stft=False, run_modal=False, run_diffusion=False)
    xs, ls = torch.from_numpy(x).to(device), torch.from_numpy(lengths).to(device)
    got = analyze_batch(xs, ls, cfg)
    with mock.patch.object(batch_module, "_band_fits", shifted_band_fits):
        ref = analyze_batch(xs, ls, cfg)
    return {k: got[k] for k in BAND_KEYS}, {k: ref[k] for k in BAND_KEYS}


def assert_bit_equal(got, ref):
    for key in BAND_KEYS:
        a, b = got[key].cpu(), ref[key].cpu()
        assert a.dtype == b.dtype and a.shape == b.shape, key
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), key
