"""
Plain PyTorch reference of every metric a bundle report prints for a tap:
alignment, IR peak, Schroeder decay and its EDT/T20/T30 fits, the band
filterbank's fits, FR peak and centroid, group-delay percentiles, the STFT
frame count and maximum, the modal cloud and the diffusion medians. The
formulas are the reference toolkit's (decay.py, rt60bands.py,
frequency_response.py, group_delay.py, spectrogram.py, modalcloud.py,
diffusion.py), written out here from the float64 oracle's definitions, one
tap at a time, with no kernel, cache, graph or batching trick. It imports
torch, numpy and this folder's tables, and nothing of the program.

`Precision` selects the arithmetic: float64 (the reference), or the control,
float32 arithmetic with every intermediate stored in bfloat16 (torch has no
bfloat16 FFT, so each transform runs in float32 on bfloat16 operands and its
result is rounded to bfloat16).

It follows the engine's documented divergences from the per-file
reference (docs/MIGRATION.md): bands are filtered, and FR and group delay
transformed, over the bundle's padded length.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch

from reference import tables


@dataclass(frozen=True)
class Precision:
    name: str
    dtype: torch.dtype
    store: Callable[[torch.Tensor], torch.Tensor]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.store(x)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    if x.is_complex():
        return torch.complex(_bf16(x.real), _bf16(x.imag))
    if not x.is_floating_point():
        return x
    return x.to(torch.bfloat16).to(torch.float32)


FLOAT64 = Precision("float64", torch.float64, lambda x: x)
BFLOAT16 = Precision("bfloat16", torch.float32, _bf16)
# the program's own precision, for a look at what float32 alone moves
FLOAT32 = Precision("float32", torch.float32, lambda x: x)
PRECISIONS = {"float64": FLOAT64, "bfloat16": BFLOAT16, "float32": FLOAT32}


@dataclass(frozen=True)
class Settings:
    """The engine's report defaults (the reference toolkit's decay.py,
    rt60bands.py, spectrogram.py, modalcloud.py and report.py defaults)."""

    sample_rate_hz: int = 48_000
    band_mode: str = "three"
    edc_epsilon: float = 1e-20
    edc_floor_db: float = -120.0
    fit_lower_limit_db: float = -80.0
    edt: tuple = (0.0, -10.0)
    t20: tuple = (-5.0, -25.0)
    t30: tuple = (-5.0, -35.0)
    f_min_hz: float = 20.0
    f_max_hz: float = 20000.0
    floor_db: float = -120.0
    n_fft: int = 4096
    hop: int = 512
    modal_n_fft: int = 8192
    modal_min_points: int = 10
    modal_min_peak_db: float = 20.0
    diffusion_window_s: float = 0.050
    diffusion_hop_s: float = 0.05
    diffusion_max_lag_ms: float = 5.0


# ---------------------------------------------------------------- decay fits


def edc_db(x: torch.Tensor, length: int, s: Settings, p: Precision) -> torch.Tensor:
    """Schroeder curve of x[:length] in dB, 0 dB at index 0, floored."""
    e = p(x[..., :length] * x[..., :length])
    edc = p(torch.flip(torch.cumsum(torch.flip(e, (-1,)), -1), (-1,)))
    edc = torch.clamp(edc, min=s.edc_epsilon)
    return torch.clamp(p(10.0 * torch.log10(p(edc / edc[..., :1]))), min=s.edc_floor_db)


def crossing(curve: torch.Tensor, target: float, rate: float):
    """(time, found) of the first sample at or below target, interpolated
    linearly from the sample before it; curves along the last axis."""
    below = curve <= target
    found = below.any(-1)
    idx = torch.argmax(below.to(torch.uint8), -1)
    prev = torch.clamp(idx - 1, min=0)
    y0 = torch.gather(curve, -1, prev[..., None])[..., 0]
    y1 = torch.gather(curve, -1, idx[..., None])[..., 0]
    same = y1 == y0
    frac = torch.clamp((target - y0) / torch.where(same, torch.ones_like(y0), y1 - y0), 0.0, 1.0)
    t0, t1 = prev.to(curve.dtype) / rate, idx.to(curve.dtype) / rate
    t = torch.where(same, t1, t0 + frac * (t1 - t0))
    return torch.where(idx == 0, torch.zeros_like(t), t), found


def fit(curve: torch.Tensor, rng: tuple, s: Settings, rate: float, p: Precision, min_points: int = 8):
    """Least-squares line over the curve between the crossings of rng[0]
    and max(rng[1], the fit's lower limit): slope, r2, rt60 = -60 / slope,
    the crossing times and ok (both found, ordered, enough points, slope < 0)."""
    t_start, f0 = crossing(curve, float(rng[0]), rate)
    t_end, f1 = crossing(curve, float(max(rng[1], s.fit_lower_limit_db)), rate)
    t = torch.arange(curve.shape[-1], device=curve.device, dtype=curve.dtype) / rate
    w = (t >= t_start[..., None]) & (t <= t_end[..., None])
    num = w.sum(-1)
    cnt = torch.clamp(num, min=1).to(curve.dtype)
    tm = p(torch.where(w, t, 0.0).sum(-1) / cnt)
    ym = p(torch.where(w, curve, 0.0).sum(-1) / cnt)
    dt = p(torch.where(w, t - tm[..., None], 0.0))
    dy = p(torch.where(w, curve - ym[..., None], 0.0))
    stt, sty = p((dt * dt).sum(-1)), p((dt * dy).sum(-1))
    slope = p(sty / torch.where(stt > 0, stt, torch.ones_like(stt)))
    res = dy - slope[..., None] * dt
    ss_res, ss_tot = p((res * res).sum(-1)), p((dy * dy).sum(-1))
    r2 = torch.where(ss_tot > 0, 1.0 - ss_res / torch.where(ss_tot > 0, ss_tot, torch.ones_like(ss_tot)),
                     torch.zeros_like(ss_tot))
    ok = f0 & f1 & (t_end > t_start) & (num >= min_points) & (slope < 0) & (stt > 0)
    rt60 = -60.0 / torch.where(slope < 0, slope, -torch.ones_like(slope))
    return {"rt60": rt60, "slope": slope, "r2": r2, "t_start": t_start, "t_end": t_end, "ok": ok}


# ---------------------------------------------------------------- one tap


def _percentiles(x: torch.Tensor, qs) -> torch.Tensor:
    """numpy's linear-interpolation percentiles over the finite values of a row."""
    x = x[torch.isfinite(x)]
    if x.numel() == 0:
        return torch.full((len(qs),), math.nan, dtype=torch.float64)
    v = torch.sort(x.to(torch.float64)).values
    out = []
    for q in qs:
        r = q / 100.0 * (v.numel() - 1)
        lo, hi = int(math.floor(r)), int(math.ceil(r))
        out.append(v[lo] + (r - lo) * (v[hi] - v[lo]))
    return torch.stack(out)


def _nanmedian(x: torch.Tensor) -> float:
    v = x[~torch.isnan(x)]
    return float(torch.quantile(v.to(torch.float64), 0.5)) if v.numel() else math.nan


def _frames(x: torch.Tensor, win: int, hop: int) -> torch.Tensor:
    t = 1 + (x.shape[-1] - win) // hop if x.shape[-1] >= win else 0
    return x[..., : (t - 1) * hop + win].unfold(-1, win, hop) if t > 0 else x.new_zeros((0, win))


def _stft_mag(x: torch.Tensor, n_fft: int, hop: int, k_out: int, p: Precision, floor_lin: float):
    """|rfft(hann * frame)| of every valid-framing frame, floored."""
    win = torch.from_numpy(np.hanning(n_fft)).to(x.device, p.dtype)
    frames = p(_frames(x, n_fft, hop) * win)
    return torch.clamp(torch.abs(p(torch.fft.rfft(frames, dim=-1)[..., :k_out])), min=floor_lin)


def _diffusion(x: torch.Tensor, length: int, win: int, hop: int, max_lag: int, p: Precision):
    """Per valid window: max |autocorr| over lags 1..min(max_lag, win-2),
    and the echo density (share of |x| above the window's rms, over the
    Gaussian expectation); NaN where the window is silent."""
    fr = _frames(x, win, hop)
    valid = torch.arange(fr.shape[0], device=x.device) * hop + win <= length
    fr = fr[valid]
    x0 = p(fr - fr.mean(-1, keepdim=True))
    denom = p((x0 * x0).sum(-1))
    usable = min(max_lag, win - 2)
    n = 1 << (win + usable).bit_length()
    spec = p(torch.fft.rfft(x0, n=n, dim=-1))
    ac = p(torch.fft.irfft(spec * spec.conj(), n=n, dim=-1))[..., 1: usable + 1]
    best = torch.abs(ac).amax(-1)
    autocorr = torch.where(denom > 1e-20, best / torch.where(denom > 1e-20, denom, 1.0), math.nan)
    rms = torch.sqrt(p(denom / win))
    expected = 2.0 * (1.0 - 0.5 * (1.0 + math.erf(1.0 / math.sqrt(2.0))))
    frac = (torch.abs(x0) > rms[..., None]).to(x0.dtype).mean(-1) / expected
    echo = torch.where(rms > 1e-20, frac, math.nan)
    return autocorr, echo, int(valid.sum())


def _stereo(l: torch.Tensor, r: torch.Tensor, length: int, win: int, hop: int, max_lag: int, p: Precision):
    lf, rf = _frames(l, win, hop), _frames(r, win, hop)
    valid = torch.arange(lf.shape[0], device=l.device) * hop + win <= length
    x0 = p(lf[valid] - lf[valid].mean(-1, keepdim=True))
    y0 = p(rf[valid] - rf[valid].mean(-1, keepdim=True))
    denom = torch.sqrt(p((x0 * x0).sum(-1)) * p((y0 * y0).sum(-1)))
    ok = denom > 1e-20
    safe = torch.where(ok, denom, 1.0)
    corr0 = torch.where(ok, p((x0 * y0).sum(-1)) / safe, math.nan)
    usable = min(max_lag, win - 2)
    n = 1 << (win + usable).bit_length()
    xc = p(torch.fft.irfft(p(torch.fft.rfft(x0, n=n)).conj() * p(torch.fft.rfft(y0, n=n)), n=n))
    lags = torch.cat([xc[..., : usable + 1], xc[..., n - usable:]], -1)
    iacc = torch.where(ok, torch.abs(lags).amax(-1) / safe, math.nan)
    return corr0, iacc


class Reference:
    """The reference for one shape of bundle: `tap(samples_i16 (C, L))` returns
    every metric of one tap as {key: numpy array over channels}."""

    def __init__(self, settings: Settings, length: int, device, precision: Precision = FLOAT64):
        self.s, self.p, self.device = settings, precision, torch.device(device)
        self.length = int(length)
        self.n = tables.padded_length(self.length)
        sr = settings.sample_rate_hz
        self.band_masks = torch.from_numpy(
            tables.band_masks(tables.bands_for(settings.band_mode, sr), self.n, sr)).to(self.device, precision.dtype)
        mat, nonempty, self.modal_k_out = tables.modal_bins(settings.modal_n_fft, sr, settings.f_min_hz,
                                                            settings.f_max_hz)
        self.modal_mat = torch.from_numpy(mat.T.copy()).to(self.device, precision.dtype)
        self.modal_nonempty = torch.from_numpy(nonempty).to(self.device)
        self.freqs = torch.fft.rfftfreq(self.n, 1.0 / sr, dtype=torch.float64).to(self.device)
        self.sel = (self.freqs >= settings.f_min_hz) & (self.freqs <= settings.f_max_hz)

    def _align(self, x: torch.Tensor, length: int):
        """x from its first absolute peak, at index 0 of a padded buffer."""
        return self._align_at(x, int(torch.argmax(torch.abs(x[:length]))), length)

    def tap(self, samples_i16: torch.Tensor) -> Dict[str, np.ndarray]:
        s, p, n, L = self.s, self.p, self.n, self.length
        sr = s.sample_rate_hz
        x = torch.zeros((samples_i16.shape[0], n), dtype=p.dtype, device=self.device)
        x[:, :L] = p(samples_i16.to(self.device, p.dtype) / 32768.0)
        out: Dict[str, list] = {}

        def put(key, value):
            out.setdefault(key, []).append(float(value) if not isinstance(value, bool) else value)

        floor_lin = 10.0 ** (s.floor_db / 20.0)
        spectrum_full = p(torch.fft.rfft(x, dim=-1))
        banded = p(torch.fft.irfft(spectrum_full[:, None, :] * self.band_masks, n=n, dim=-1))
        del spectrum_full
        for c in range(x.shape[0]):
            seg, start, seg_len = self._align(x[c], L)
            put("start_index", start)
            put("segment_length", seg_len)
            put("peak_abs", torch.abs(x[c, :L]).max())
            curve = edc_db(seg, seg_len, s, p)
            t10, f10 = crossing(curve, -10.0, sr)
            put("early10_time", t10)
            put("early10_ok", bool(f10))
            for name in ("edt", "t20", "t30"):
                for k, v in fit(curve, getattr(s, name), s, sr, p).items():
                    put(f"{name}_{k}", bool(v) if k == "ok" else v)
            del curve
            # bands: filtered over the padded signal, then aligned at the
            # broadband start
            bseg = banded[c, :, start:L]
            bcurve = edc_db(bseg, seg_len, s, p)
            for name in ("t30", "t20", "edt"):
                f = fit(bcurve, getattr(s, name), s, sr, p)
                out.setdefault(f"band_{name}_rt60", []).append(f["rt60"].cpu().numpy())
                out.setdefault(f"band_{name}_ok", []).append(f["ok"].cpu().numpy())
            del bseg, bcurve
            # FR and group delay over the padded length
            idx = torch.arange(n, device=self.device, dtype=p.dtype)
            hann = torch.where(idx < seg_len, 0.5 - 0.5 * torch.cos(2.0 * math.pi * idx / max(seg_len - 1, 1)), 0.0)
            spec = p(torch.fft.rfft(p(seg * hann)))
            mag = torch.clamp(torch.abs(spec), min=floor_lin).to(torch.float64)
            mag_sel = torch.where(self.sel, mag, 0.0)
            put("fr_peak_hz", self.freqs[torch.argmax(mag_sel)])
            put("fr_centroid_hz", (mag_sel * self.freqs).sum() / torch.clamp(mag_sel.sum(), min=1e-30))
            out.setdefault("fr_mag", []).append(mag_sel)
            phase = p(torch.angle(spec))
            d = torch.diff(phase)
            dmod = torch.remainder(d + math.pi, 2 * math.pi) - math.pi
            dmod = torch.where((dmod == -math.pi) & (d > 0), math.pi, dmod)
            corr = torch.where(torch.abs(d) < math.pi, 0.0, dmod - d)
            phase = p(torch.cat([phase[:1], phase[1:] + p(torch.cumsum(corr, -1))]))
            gd = p(-torch.gradient(phase)[0] / (2.0 * math.pi / n))
            q = _percentiles(gd[self.sel], (10.0, 50.0, 90.0))
            put("gd_p10", q[0])
            put("gd_median", q[1])
            put("gd_p90", q[2])
            del spec, mag, mag_sel, phase, gd
            # shared STFT: frame count and the largest magnitude
            frames_valid = max(0, 1 + (seg_len - s.n_fft) // s.hop) if seg_len >= s.n_fft else 0
            put("stft_num_frames", frames_valid)
            best = 0.0
            for lo in range(0, frames_valid, 1024):
                hi = min(frames_valid, lo + 1024)
                m = _stft_mag(seg[lo * s.hop: (hi - 1) * s.hop + s.n_fft], s.n_fft, s.hop, s.n_fft // 2 + 1, p,
                              floor_lin)
                best = max(best, float(m.max()))
            put("stft_global_max_db", 20.0 * math.log10(max(best, floor_lin)))
            # modal cloud: log-bin means of the linear STFT, each bin's dB
            # curve fitted over T30 below its peak, frames at sr / hop
            mframes = max(0, 1 + (seg_len - s.modal_n_fft) // s.hop) if seg_len >= s.modal_n_fft else 0
            mag = _stft_mag(seg[: (mframes - 1) * s.hop + s.modal_n_fft], s.modal_n_fft, s.hop, self.modal_k_out, p,
                            floor_lin)
            binned = p(mag @ self.modal_mat)
            curves = p(20.0 * torch.log10(torch.clamp(binned, min=1e-30))).T
            peak = curves.amax(-1, keepdim=True)
            f = fit(p(curves - peak), s.t30, s, sr / s.hop, p, s.modal_min_points)
            reliable = f["ok"] & self.modal_nonempty & ((peak[:, 0] - s.floor_db) >= s.modal_min_peak_db)
            rt60 = torch.where(reliable, f["rt60"], math.nan).to(torch.float64)
            put("modal_count", int(reliable.sum()))
            v = rt60[~torch.isnan(rt60)]
            put("modal_median_rt60", torch.quantile(v, 0.5) if v.numel() else math.nan)
            put("modal_p90_rt60", torch.quantile(v, 0.9) if v.numel() else math.nan)
            put("modal_max_rt60", v.max() if v.numel() else math.nan)
            out.setdefault("modal_rt60", []).append(rt60.cpu().numpy())
            out.setdefault("modal_r2", []).append(torch.where(reliable, f["r2"], math.nan).to(torch.float64).cpu().numpy())
            del mag, binned, curves
            # diffusion
            win = max(16, int(round(s.diffusion_window_s * sr)))
            hop = max(1, int(round(s.diffusion_hop_s * sr)))
            lag = max(1, int(round(s.diffusion_max_lag_ms / 1000.0 * sr)))
            ac, echo, frames = _diffusion(seg, seg_len, win, hop, lag, p)
            put("diff_median_autocorr", _nanmedian(ac))
            put("diff_median_echo_density", _nanmedian(echo))
            put("diff_num_frames", frames)
        del banded
        # stereo: L/R aligned at the peak of their mean
        if x.shape[0] == 2:
            comb = x.mean(0)
            _, start, seg_len = self._align(comb, L)
            l, _, _ = self._align_at(x[0], start, L)
            r, _, _ = self._align_at(x[1], start, L)
            win = max(16, int(round(s.diffusion_window_s * sr)))
            hop = max(1, int(round(s.diffusion_hop_s * sr)))
            lag = max(1, int(round(s.diffusion_max_lag_ms / 1000.0 * sr)))
            corr0, iacc = _stereo(l, r, seg_len, win, hop, lag, p)
            out["diff_median_corr0"] = _nanmedian(corr0)
            out["diff_median_iacc"] = _nanmedian(iacc)
        result = {}
        for k, v in out.items():
            if k == "fr_mag":
                result[k] = torch.stack(v)  # stays on the device for the peak check
            elif isinstance(v, list):
                result[k] = np.stack([np.asarray(e.cpu() if torch.is_tensor(e) else e) for e in v])
            else:
                result[k] = np.asarray(v)
        return result

    def _align_at(self, x: torch.Tensor, start: int, length: int):
        seg = torch.zeros(self.n, dtype=x.dtype, device=x.device)
        seg[: length - start] = x[start:length]
        return seg, start, length - start
