"""
The fused batched analysis engine (audio_analysis_tpu/engine/batch.py).

`analyze_batch` computes every report metric for a chunk of taps in one
pass over device tensors: alignment, decay (EDC + fits), RT60 bands, FR,
group delay, STFT, modal cloud and diffusion, each block under the same
toggle as the JAX engine, with the JAX engine's output keys, shapes and
dtypes (bool `*_ok` flags, int32 indices and counts, float32 elsewhere).

Shapes: samples (B, C, N) float32 zero-padded or raw int16 PCM (scaled by
1/32768 on the device), lengths (B,) int32.

`analyze_bundle_pipelined` is the host entry of the bundle report: chunk
k+1 decodes and uploads on a worker thread (pinned host memory, a side
stream, an event the compute stream waits on) while chunk k computes, and
each chunk comes back in one packed device-to-host copy. On a mesh
(engine.mesh) each chunk is cut into one block per device.
"""

from __future__ import annotations

import math
import time
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np
import torch

from audio_analysis_tpu_torch.engine.config import EngineConfig
from audio_analysis_tpu_torch.ops import (
    dbfit,
    diffusion as dops,
    edc,
    fftmask,
    logfreq,
    selectq,
    stft,
    trim,
)
from audio_analysis_tpu_torch.ops.common import (
    hann_window_dynamic,
    nanmax,
    nanmedian,
    unwrap,
)

_NP_DTYPES = {torch.bool: np.bool_, torch.int32: np.int32, torch.float32: np.float32}
# a frame block's plane per tap group (frame_tap_groups): at the report
# defaults a chunk of 8 stereo taps of 2^20 samples counts 0.54 GB (shared
# STFT) and 1.07 GB (modal cloud), one group each, as do 16-tap chunks
FRAME_PLANE_BUDGET_BYTES = 4 << 30


def _band_definitions(config: EngineConfig):
    if config.band_mode == "three":
        return fftmask.build_three_band_definitions(
            config.sample_rate_hz,
            config.low_upper_hz,
            config.mid_center_hz,
            config.mid_width_octaves,
            config.high_lower_hz,
        )
    if config.band_mode in ("octave", "third"):
        per_octave = 1 if config.band_mode == "octave" else 3
        return fftmask.build_fractional_octave_band_definitions(
            config.sample_rate_hz, per_octave, config.band_f_min_hz, config.band_f_max_hz
        )
    raise ValueError(f"Unknown band_mode: {config.band_mode!r}")


def band_names(config: EngineConfig) -> Tuple[str, ...]:
    """Band labels matching the engine's band_* output axis (host-side)."""
    return tuple(band.name for band in _band_definitions(config))


def band_masks(config: EngineConfig, n: int) -> np.ndarray:
    return fftmask.build_band_mask_matrix(
        _band_definitions(config), n, config.sample_rate_hz, config.transition_width_octaves
    )


def modal_tables(config: EngineConfig) -> Tuple[np.ndarray, np.ndarray, int | None]:
    """(bin matrix (bins, k_out), nonempty (bins,), k_out): the modal log-bin
    matrix, cut at the last rfft column any bin uses when modal_trim_bins."""
    _centres, bin_matrix, nonempty = logfreq.modal_bin_matrix(config)
    k_out = None
    if config.modal_trim_bins:
        nonzero_cols = np.nonzero(bin_matrix.any(axis=0))[0]
        if nonzero_cols.size:
            k_out = int(nonzero_cols[-1]) + 1
            bin_matrix = bin_matrix[:, :k_out]
    return bin_matrix, nonempty, k_out


@lru_cache(maxsize=4)
def _device_tables(config: EngineConfig, n: int, device: torch.device) -> Dict:
    """The constant tables of one (config, N) on the device, uploaded once:
    an upload from pageable host memory would stall every later chunk's
    dispatch on the compute stream."""
    sr = config.sample_rate_hz
    nyquist = 0.5 * sr
    f_min = float(np.clip(config.f_min_hz, 0.0, nyquist))
    f_max = float(np.clip(config.f_max_hz, f_min, nyquist))
    freqs = np.fft.rfftfreq(n, 1.0 / sr).astype(np.float32)
    tables = {
        "freqs": torch.from_numpy(freqs),
        "sel": torch.from_numpy((freqs >= f_min) & (freqs <= f_max)),
    }
    groups = []
    num_bands = 0
    if config.run_bands:
        masks = band_masks(config, n)
        num_bands = masks.shape[0]
        factors = fftmask.band_decimation_factors(masks, n) if config.bands_decimate else ()
        if any(k > 1 for k in factors):
            # one cropped mask table per distinct factor, ascending, and the
            # permutation that puts the groups' columns back in band order
            by_factor: Dict[int, list] = {}
            for band, k in enumerate(factors):
                by_factor.setdefault(k, []).append(band)
            groups = [(k, fftmask.crop_half_masks(masks[bands], n, k)) for k, bands in sorted(by_factor.items())]
            order = [band for _k, bands in sorted(by_factor.items()) for band in bands]
            tables["band_order"] = torch.from_numpy(np.argsort(order))
        else:
            tables["band_masks"] = torch.from_numpy(masks)
    if config.run_modal:
        bin_matrix, nonempty, _k_out = modal_tables(config)
        tables["modal_bins_t"] = torch.from_numpy(np.ascontiguousarray(bin_matrix.T))
        tables["modal_nonempty"] = torch.from_numpy(nonempty)
    out: Dict = {k: v.to(device) for k, v in tables.items()}
    # (factor, cropped mask table) per decimation group (empty at full
    # rate), and the band count
    out["band_groups"] = tuple((k, torch.from_numpy(m).to(device)) for k, m in groups)
    out["num_bands"] = num_bands
    return out


def _fit_metrics(fit: dbfit.DecayFit, prefix: str) -> Dict[str, torch.Tensor]:
    return {
        f"{prefix}_rt60": fit.rt60_seconds,
        f"{prefix}_slope": fit.slope_db_per_second,
        f"{prefix}_r2": fit.r_squared,
        f"{prefix}_t_start": fit.start_time_seconds,
        f"{prefix}_t_end": fit.end_time_seconds,
        f"{prefix}_ok": fit.ok,
    }


def _band_fits(banded, start, length, factor: int, config: EngineConfig) -> Dict[str, torch.Tensor]:
    """Per-band alignment at the broadband start, EDC and the T30/T20/EDT
    fits of a (..., C, bands, N/factor) band plane -> (..., C, bands)."""
    plane = banded.shape[:-1]
    if factor > 1:
        start, length = start // factor, length // factor
    aligned = trim.shift_to(banded, start[..., None].expand(plane), length[..., None].expand(plane))
    del banded  # the caller passes the plane without keeping it
    curve = edc.schroeder_edc_db(
        aligned.samples, aligned.length, config.edc_epsilon, config.edc_floor_db
    )
    res = {}
    for name, range_db in (
        ("band_t30", config.t30_range_db),
        ("band_t20", config.t20_range_db),
        ("band_edt", config.edt_range_db),
    ):
        fit = dbfit.fit_decay_slope_over_db_range(
            curve.edc_db, curve.length, range_db, config.fit_lower_limit_db,
            config.sample_rate_hz / factor,
        )
        res[f"{name}_rt60"] = fit.rt60_seconds
        res[f"{name}_ok"] = fit.ok
    return res


def _bands(samples, start, length, tables, config: EngineConfig) -> Dict[str, torch.Tensor]:
    """Band filterbank (the filter sees the full signal, then trims) and
    the band fits for (..., C, N) samples -> (..., C, bands).

    With decimation groups (`config.bands_decimate`), one forward transform
    is shared; each group of bands with the same factor k is inverse-
    transformed at N/k, aligned at start // k and fitted at sr / k, and the
    groups' columns are put back in band order."""
    n = samples.shape[-1]
    if not tables["band_groups"]:
        return _band_fits(fftmask.apply_band_masks(samples, tables["band_masks"]), start, length, 1, config)
    kind, spectrum = fftmask.full_band_spectrum(samples)
    per_group = [
        _band_fits(fftmask.banded_from_spectrum(kind, spectrum, masks, n, k), start, length, k, config)
        for k, masks in tables["band_groups"]
    ]
    del spectrum
    order = tables["band_order"]
    return {
        key: torch.cat([res[key] for res in per_group], dim=-1).index_select(-1, order)
        for key in per_group[0]
    }


def frame_tap_groups(taps: int, channels: int, n: int, n_fft: int, hop: int) -> List[Tuple[int, int]]:
    """[lo, hi) tap ranges of one frame block (the shared STFT or the modal
    cloud). Its per-frame planes are the device-memory high-water mark: the
    JAX engine maps them over taps one at a time; the port runs a chunk's
    taps in one launch while their plane (a complex value per frame and
    bin, the plain route's spectrum) stays within FRAME_PLANE_BUDGET_BYTES,
    and splits the chunk by taps past it."""
    per_tap = channels * stft.num_frames_static(n, n_fft, hop) * (n_fft + 2) * 4
    step = max(1, FRAME_PLANE_BUDGET_BYTES // max(per_tap, 1))
    return [(lo, min(taps, lo + step)) for lo in range(0, taps, step)]


def _modal_fits(samples, length, tables, config: EngineConfig):
    """(reliable, rt60, r2) of every modal log bin, (B, C, bins) each: the
    modal STFT binned in linear magnitude, each bin's dB curve fitted over
    the T30 range below its peak."""
    _bins, _nonempty, k_out = modal_tables(config)
    stm = stft.stft_magnitude(
        samples, length, config.modal_n_fft, config.hop_length, True,
        10.0 ** (config.magnitude_floor_db / 20.0), k_out,
    )
    # bin means in linear magnitude (one fp32 matmul), dB once at the end
    binned = torch.matmul(stm.mag, tables["modal_bins_t"])  # (B, C, T, bins)
    curves_db = torch.transpose(20.0 * torch.log10(torch.clamp(binned, min=1e-30)), -1, -2)
    del binned
    t_total = curves_db.shape[-1]
    frame_valid = torch.arange(t_total, device=samples.device) < stm.num_frames[..., None]
    curves_db = torch.where(frame_valid[..., None, :], curves_db, config.magnitude_floor_db)
    peak = curves_db.amax(dim=-1, keepdim=True)
    rel = curves_db - peak
    frame_len = stm.num_frames[..., None].expand(rel.shape[:-1])
    fit = dbfit.fit_decay_slope_over_db_range(
        rel,
        frame_len,
        config.t30_range_db,
        config.fit_lower_limit_db,
        config.sample_rate_hz / config.hop_length,
        min_points=config.modal_min_fit_points,
    )
    reliable = (
        fit.ok
        & tables["modal_nonempty"]
        & ((peak[..., 0] - config.magnitude_floor_db) >= config.modal_min_peak_db_above_floor)
    )
    return reliable, fit.rt60_seconds, fit.r_squared


def _require_frames(n: int, n_fft: int, hop: int, name: str) -> None:
    """A frame block needs at least one frame of the padded signal: the JAX
    engine raises a ValueError there (its per-row max over no frames), and
    so does the port, on every device and before any launch."""
    if stft.num_frames_static(n, n_fft, hop) == 0:
        raise ValueError(f"{name}={n_fft} is longer than the {n}-sample signal: the STFT has no frame")


def analyze_batch(
    samples: torch.Tensor,  # (B, C, N) float32 or int16
    lengths: torch.Tensor,  # (B,) int32
    config: EngineConfig = EngineConfig(),
) -> Dict[str, torch.Tensor]:
    """The full fused metric computation. Returns a dict of (B, C, ...) tensors."""
    sr = config.sample_rate_hz
    if samples.dtype == torch.int16:
        # PCM16 arrives raw and converts on the device: the upload moves
        # half the bytes of float32
        samples = samples.to(torch.float32) * (1.0 / 32768.0)
    if config.downmix_to_mono and samples.shape[1] > 1:
        samples = samples.mean(dim=1, keepdim=True)
    b, c, n = samples.shape
    if config.run_stft:
        _require_frames(n, config.n_fft, config.hop_length, "n_fft")
    if config.run_modal:
        _require_frames(n, config.modal_n_fft, config.hop_length, "modal_n_fft")
    device = samples.device
    lengths = lengths.to(torch.int32)
    lengths_bc = lengths[:, None].expand(b, c)
    tables = _device_tables(config, n, device)

    out: Dict[str, torch.Tensor] = {}

    # ---- alignment (per channel, like every reference module) ----
    aligned = trim.align_for_analysis(
        samples, lengths_bc, sr, config.trim_to_peak, config.ignore_leading_seconds
    )
    out["start_index"] = aligned.start_index
    out["segment_length"] = aligned.length

    # ---- IR view stats (peak of the raw signal, pre-trim) ----
    valid = torch.arange(n, dtype=torch.int32, device=device) < lengths_bc[..., None]
    out["peak_abs"] = torch.where(valid, torch.abs(samples), 0.0).amax(dim=-1)
    del valid

    # ---- decay: EDC + fits ----
    curve = edc.schroeder_edc_db(
        aligned.samples, aligned.length, config.edc_epsilon, config.edc_floor_db
    )
    c0 = dbfit.crossing_time(curve.edc_db, curve.length, 0.0, sr)
    c10 = dbfit.crossing_time(curve.edc_db, curve.length, -10.0, sr)
    out["early10_time"] = c10.time_seconds - c0.time_seconds
    out["early10_ok"] = c0.found & c10.found & (c10.time_seconds >= c0.time_seconds)
    for name, range_db in (
        ("edt", config.edt_range_db),
        ("t20", config.t20_range_db),
        ("t30", config.t30_range_db),
    ):
        fit = dbfit.fit_decay_slope_over_db_range(
            curve.edc_db, curve.length, range_db, config.fit_lower_limit_db, sr
        )
        out.update(_fit_metrics(fit, name))
    del curve

    # ---- rt60 bands: the filter sees the full signal, then trims ----
    if config.run_bands:
        if tables["num_bands"] > 3:
            # octave/third-octave: the (C, bands, N) filterbank plane is the
            # memory high-water mark, so taps go one at a time
            per_tap = [
                _bands(samples[i], aligned.start_index[i], lengths_bc[i], tables, config)
                for i in range(b)
            ]
            out.update({k: torch.stack([r[k] for r in per_tap]) for k in per_tap[0]})
        else:
            out.update(_bands(samples, aligned.start_index, lengths_bc, tables, config))

    # ---- frequency response diagnostics ----
    freqs, sel = tables["freqs"], tables["sel"]
    floor_lin = 10.0 ** (config.magnitude_floor_db / 20.0)
    if config.run_fr or config.run_group_delay:
        windowed = aligned.samples * hann_window_dynamic(n, aligned.length)
        spectrum = torch.fft.rfft(windowed, dim=-1)
        del windowed

    if config.run_fr:
        mag = torch.clamp(torch.abs(spectrum), min=floor_lin)
        mag_sel = torch.where(sel, mag, 0.0)
        out["fr_peak_hz"] = freqs[torch.argmax(mag_sel, dim=-1)]
        wsum = mag_sel.sum(dim=-1)
        out["fr_centroid_hz"] = (mag_sel * freqs).sum(dim=-1) / torch.clamp(wsum, min=1e-30)
        del mag, mag_sel

    # ---- group delay ----
    if config.run_group_delay:
        phase = unwrap(torch.angle(spectrum))
        dw = 2.0 * math.pi / n
        gd = -(torch.gradient(phase, dim=-1)[0] / dw)
        q = selectq.masked_percentiles(gd, sel.expand(gd.shape), (10.0, 50.0, 90.0))
        out["gd_p10"] = q[..., 0]
        out["gd_median"] = q[..., 1]
        out["gd_p90"] = q[..., 2]
        del phase, gd

    # ---- shared STFT: only the per-row max and the frame count are used ----
    if config.run_stft:
        num_frames, global_max_lin = [], []
        for lo, hi in frame_tap_groups(b, c, n, config.n_fft, config.hop_length):
            st = stft.stft_magnitude(
                aligned.samples[lo:hi], aligned.length[lo:hi], config.n_fft, config.hop_length, True, floor_lin
            )
            num_frames.append(st.num_frames)
            # max in linear magnitude, dB once on the (B, C) result
            global_max_lin.append(st.mag.amax(dim=(-2, -1)))
            del st
        out["stft_num_frames"] = torch.cat(num_frames)
        out["stft_global_max_db"] = 20.0 * torch.log10(torch.clamp(torch.cat(global_max_lin), min=floor_lin))

    # ---- modal cloud ----
    if config.run_modal:
        groups = [
            _modal_fits(aligned.samples[lo:hi], aligned.length[lo:hi], tables, config)
            for lo, hi in frame_tap_groups(b, c, n, config.modal_n_fft, config.hop_length)
        ]
        reliable = torch.cat([g[0] for g in groups])
        rt60 = torch.where(reliable, torch.cat([g[1] for g in groups]), math.nan)
        out["modal_count"] = reliable.sum(dim=-1, dtype=torch.int32)
        out["modal_median_rt60"] = nanmedian(rt60)
        out["modal_p90_rt60"] = torch.nanquantile(rt60, 0.9, dim=-1)
        out["modal_max_rt60"] = nanmax(rt60)
        out["modal_rt60"] = rt60  # (B, C, bins) for scatter plots
        out["modal_r2"] = torch.where(reliable, torch.cat([g[2] for g in groups]), math.nan)
        del groups

    # ---- diffusion (report defaults) ----
    if config.run_diffusion:
        win = max(16, int(round(config.diffusion_window_seconds * sr)))
        hop = max(1, int(round(config.diffusion_hop_seconds * sr)))
        max_lag = max(1, int(round(config.diffusion_max_lag_ms / 1000.0 * sr)))
        series = dops.diffusion_metrics(
            aligned.samples, aligned.length, win, hop, max_lag, sr,
            config.echo_density_threshold_rms, True,
        )
        out["diff_median_autocorr"] = nanmedian(series.max_abs_autocorr)
        out["diff_median_echo_density"] = nanmedian(series.echo_density)
        out["diff_num_frames"] = series.num_frames

        # stereo-only metrics: corr0/IACC need an L/R pair (diffusion.py:
        # 154-202), so C == 2 gates them statically
        if c == 2:
            # align L/R at the peak of the (L+R)/2 downmix
            combined = samples.mean(dim=1)  # (B, N)
            comb_aligned = trim.align_for_analysis(
                combined, lengths, sr, config.trim_to_peak, config.ignore_leading_seconds
            )
            start = comb_aligned.start_index
            l_al = trim.shift_to(samples[:, 0, :], start, lengths)
            r_al = trim.shift_to(samples[:, -1, :], start, lengths)
            stereo = dops.stereo_diffusion_metrics(
                l_al.samples, r_al.samples, l_al.length, win, hop, max_lag
            )
            out["diff_median_corr0"] = nanmedian(stereo.corr0)
            out["diff_median_iacc"] = nanmedian(stereo.iacc_max)

    return out


# ----------------------------------------------------------------------------
# packed transport: one device->host copy per chunk
# ----------------------------------------------------------------------------


def analyze_batch_flat(
    samples: torch.Tensor, lengths: torch.Tensor, config: EngineConfig = EngineConfig()
):
    """`analyze_batch` packed into one float32 vector on the device, with
    its (key, shape, numpy dtype) layout for `unpack_flat`."""
    out = analyze_batch(samples, lengths, config)
    keys = sorted(out)
    spec = [(k, tuple(out[k].shape), _NP_DTYPES[out[k].dtype]) for k in keys]
    flat = torch.cat([out[k].to(torch.float32).reshape(-1) for k in keys])
    return flat, spec


def unpack_flat(flat: np.ndarray, spec) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    offset = 0
    for key, shape, dtype in spec:
        size = int(np.prod(shape)) if shape else 1
        chunk = flat[offset : offset + size].reshape(shape)
        if np.issubdtype(dtype, np.bool_):
            chunk = chunk > 0.5
        elif np.issubdtype(dtype, np.integer):
            chunk = chunk.astype(dtype)
        out[key] = chunk
        offset += size
    return out


def fetch_packed(flats, spec) -> "list[Dict[str, np.ndarray]]":
    """Fetch many flat metric vectors in one device->host copy
    (concatenated on the device), then unpack each against `spec`."""
    packed = (torch.cat(flats) if len(flats) > 1 else flats[0]).cpu().numpy()
    per = int(flats[0].shape[0])
    return [unpack_flat(packed[i * per : (i + 1) * per], spec) for i in range(len(flats))]


def _pad_fill_length(n_max: int) -> int:
    """Claimed valid length of the all-zero taps that pad a short final
    chunk up to the chunk size: long enough that their fits and masks stay
    in range (they are dropped after the fetch)."""
    return n_max // 2


def analyze_bundle_pipelined(
    loader,
    lengths: np.ndarray,
    n_max: int,
    config: EngineConfig = EngineConfig(),
    chunk_taps: int = 16,
    mesh=None,
    timings: "Dict[str, float] | None" = None,
    device_chunk_cache=None,
    prefetch_chunks: int = 2,
    on_chunk_result=None,
    device: "str | torch.device" = "cuda",
) -> Dict[str, np.ndarray]:
    """
    Pipelined host entry: `loader(lo, hi)` decodes taps [lo, hi) into a
    (hi-lo, C, n_max) host chunk (io.bundle.open_bundle_chunks_i16).
    A worker thread decodes chunk k+1 and uploads it (pinned host tensor,
    non-blocking copy on a side stream, an event the compute stream waits
    on) while chunk k computes. `prefetch_chunks` chunks decode and upload
    ahead of the one being computed (>= 1).

    With `mesh` (engine.mesh.make_mesh: a tuple of devices) a chunk is
    `chunk_taps` taps per shard (fewer for a small bundle), each shard's
    contiguous block uploaded to its own device on that device's side
    stream, and `device` is not used; results still come back in one
    packed copy.

    `device_chunk_cache`: an object with `get(chunk_index)` and
    `put(chunk_index, blocks)`, where blocks is the chunk's tuple of
    per-shard device tensors (one for a single device); a hit skips that
    chunk's decode and upload.

    `on_chunk_result(lo, hi, res)`: when given, results are fetched one
    chunk at a time, in order, and the callback runs on each (pad-trimmed)
    chunk dict; otherwise every chunk comes back in one packed copy.
    """
    from audio_analysis_tpu_torch.engine.mesh import analyze_batch_sharded_flat

    shards = tuple(mesh) if mesh is not None else (torch.device(device),)
    b = int(len(lengths))
    per_shard = max(1, min(chunk_taps, -(-b // len(shards))))
    chunk = per_shard * len(shards)
    lengths = np.asarray(lengths, np.int32)
    use_cache = device_chunk_cache is not None
    side_streams = {d: torch.cuda.Stream(d) for d in dict.fromkeys(shards) if d.type == "cuda"}

    def upload(host: np.ndarray):
        """Each shard's block of `host`: (device tensor, event or None,
        pinned host tensor kept alive) per shard."""
        blocks = []
        for i, dev in enumerate(shards):
            tensor = torch.from_numpy(np.ascontiguousarray(host[i * per_shard : (i + 1) * per_shard]))
            if dev.type != "cuda":
                blocks.append((tensor.to(dev), None, None))
                continue
            pinned = tensor.pin_memory()
            with torch.cuda.stream(side_streams[dev]):
                block = pinned.to(dev, non_blocking=True)
                event = torch.cuda.Event()
                event.record(side_streams[dev])
            blocks.append((block, event, pinned))
        return blocks

    def load_chunk(lo: int, hi: int):
        take = hi - lo
        cl = lengths[lo:hi]
        if take < chunk:
            cl = np.concatenate([cl, np.full(chunk - take, _pad_fill_length(n_max), np.int32)])
        length_blocks = upload(cl)
        hit = device_chunk_cache.get(lo // chunk) if use_cache else None
        if hit is None:
            cb = loader(lo, hi)
            if take < chunk:
                pad = np.zeros((chunk - take,) + cb.shape[1:], cb.dtype)
                cb = np.concatenate([cb, pad], axis=0)
            audio_blocks = upload(cb)
            if use_cache:
                device_chunk_cache.put(lo // chunk, tuple(block for block, _, _ in audio_blocks))
        else:
            audio_blocks = [(block, None, None) for block in hit]
        return length_blocks, audio_blocks

    decode_wait_s = dispatch_s = 0.0
    flats = []
    takes = []
    spec = None
    prefetch = max(1, int(prefetch_chunks))
    starts = list(range(0, b, chunk))
    with ThreadPoolExecutor(max_workers=prefetch) as ex:
        futs = {
            i: ex.submit(load_chunk, starts[i], min(b, starts[i] + chunk))
            for i in range(min(prefetch, len(starts)))
        }
        for i, lo in enumerate(starts):
            hi = min(b, lo + chunk)
            t0 = time.perf_counter()
            length_blocks, audio_blocks = futs.pop(i).result()
            decode_wait_s += time.perf_counter() - t0
            nxt = i + prefetch
            if nxt < len(starts):
                futs[nxt] = ex.submit(load_chunk, starts[nxt], min(b, starts[nxt] + chunk))
            t0 = time.perf_counter()
            for blocks in (length_blocks, audio_blocks):
                for dev, (block, event, _pinned) in zip(shards, blocks):
                    if event is not None:
                        compute = torch.cuda.current_stream(dev)
                        compute.wait_event(event)
                        block.record_stream(compute)
            flat, spec = analyze_batch_sharded_flat(
                shards, [blk for blk, _, _ in audio_blocks], [blk for blk, _, _ in length_blocks], config
            )
            flats.append(flat)
            dispatch_s += time.perf_counter() - t0
            takes.append(hi - lo)

    chunks = []
    callback_s = 0.0
    if on_chunk_result is None:
        t0 = time.perf_counter()
        fetched = fetch_packed(flats, spec)
        fetch_s = time.perf_counter() - t0
        for res, take in zip(fetched, takes):
            if take < chunk:
                res = {k: v[:take] for k, v in res.items()}
            chunks.append(res)
    else:
        fetch_s = 0.0
        for k_idx, (flat, take) in enumerate(zip(flats, takes)):
            t0 = time.perf_counter()
            res = unpack_flat(flat.cpu().numpy(), spec)
            fetch_s += time.perf_counter() - t0
            if take < chunk:
                res = {k: v[:take] for k, v in res.items()}
            lo = k_idx * chunk
            t0 = time.perf_counter()
            on_chunk_result(lo, lo + take, res)
            callback_s += time.perf_counter() - t0
            chunks.append(res)
    if timings is not None:
        # decode_wait = time blocked on the worker's decode + upload;
        # dispatch = enqueueing the chunk's device work; fetch = the packed
        # device->host copies (including waiting out device compute)
        timings["decode_wait_s"] = round(decode_wait_s, 4)
        timings["h2d_dispatch_s"] = round(dispatch_s, 4)
        timings["fetch_s"] = round(fetch_s, 4)
        if on_chunk_result is not None:
            timings["chunk_callback_s"] = round(callback_s, 4)
    return {k: np.concatenate([ch[k] for ch in chunks], axis=0) for k in chunks[0]}


def analyze_bundle(
    batch: np.ndarray,
    lengths: np.ndarray,
    config: EngineConfig = EngineConfig(),
    chunk_taps: int = 16,
    device: "str | torch.device" = "cuda",
    mesh=None,
) -> Dict[str, np.ndarray]:
    """Host entry for a bundle already decoded into one (B, C, N) array:
    the pipelined entry over slices of it (on `mesh` when given)."""
    return analyze_bundle_pipelined(
        lambda lo, hi: batch[lo:hi],
        lengths,
        batch.shape[-1],
        config,
        chunk_taps,
        mesh=mesh,
        device=device,
    )
