"""A run of each cell end to end at a tiny size, here on the CPU (the
program's plain torch versions), the card's look skipped: `correct` holds
on the sound program, and comes out false with the timed path broken
underneath (half of each chunk left out, an answer altered where the engine
produces it: the headline T30, or one modal bin's rt60 with its summaries
left alone; a call that never answers) and with the reference's bfloat16
control put in the program's place."""

import json
import time

import pytest
import torch

from benchlib import runner, spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
TINY = {"taps": 2, "samples": 48000}
SEED = 3_000_000_019  # above 2^31, as the driver's seeds are


def tiny_run(cell, tmp_path, seconds=0.5, device="cpu", need_card=False):
    return runner.run(cell, SEED, seconds, False, time.perf_counter(), device_name=device, scale=TINY,
                      need_card=need_card, workdir=tmp_path / cell)[0]


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_is_correct(cell, tmp_path):
    res = tiny_run(cell, tmp_path)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] >= TINY["taps"]
    names = {m["name"] for m in spec.resolve(cell).end_to_end}
    assert set(res["metrics"]) == names - {"peak_alloc_gib"}  # no allocator reading off the card
    assert list(res)[-1] == "check"
    assert set(res["check"]) == set(spec.resolve(cell).limits["limits"])


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_inputs(cell, tmp_path):
    c = spec.resolve(cell)
    a = spec.entry(c.mix["entry"]).Entry(c, SEED, "cpu", tmp_path / "a", TINY)
    b = spec.entry(c.mix["entry"]).Entry(c, SEED, "cpu", tmp_path / "b", TINY)
    d = spec.entry(c.mix["entry"]).Entry(c, SEED + 1, "cpu", tmp_path / "d", TINY)
    for e in (a, b, d):
        e.make_inputs()
    assert all((x == y).all() for x, y in zip(a.inputs, b.inputs))
    assert not (a.inputs[0] == d.inputs[0]).all() and not (a.inputs[0] == a.inputs[1]).all()
    assert (tmp_path / "a/capture0/taps/tap00.wav").read_bytes() == (tmp_path / "b/capture0/taps/tap00.wav").read_bytes()


def _half_the_batch(analyze_batch):
    def broken(samples, lengths, config):
        half = max(1, samples.shape[0] // 2)
        out = analyze_batch(samples[:half], lengths[:half], config)
        return {k: torch.cat([v, v[: samples.shape[0] - half]]) for k, v in out.items()}
    return broken


def _altered_answer(analyze_batch):
    def broken(samples, lengths, config):
        out = analyze_batch(samples, lengths, config)
        out["t30_rt60"] = out["t30_rt60"].clone()
        out["t30_rt60"][0, 0] *= 1.01  # the headline T30, 1% off
        return out
    return broken


def _altered_modal_bin(analyze_batch):
    def broken(samples, lengths, config):
        out = analyze_batch(samples, lengths, config)
        rt60 = out["modal_rt60"].clone()
        b = int(torch.nonzero(~torch.isnan(rt60[0, 0]))[0])
        rt60[0, 0, b] *= 2.0  # one reliable bin's fit, its summaries left alone
        out["modal_rt60"] = rt60
        return out
    return broken


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_half_the_batch, _altered_answer, _altered_modal_bin])
def test_a_broken_engine_is_not_correct(cell, fault, tmp_path, monkeypatch):
    from audio_analysis_tpu_torch.engine import batch

    monkeypatch.setattr(batch, "analyze_batch", fault(batch.analyze_batch))
    res = tiny_run(cell, tmp_path)
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["check"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_a_call_that_never_answers_is_not_correct(cell, tmp_path, monkeypatch):
    from audio_analysis_tpu_torch.report import engine_report

    calls = {"n": 0}
    real = engine_report.run_bundle_report_engine

    def sometimes(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 3:  # the window's first call (two warm calls before it)
            raise RuntimeError("lost")
        return real(*args, **kwargs)

    monkeypatch.setattr(engine_report, "run_bundle_report_engine", sometimes)
    res = tiny_run(cell, tmp_path, seconds=1.0)
    assert res["failed"] >= TINY["taps"] and not res["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_bfloat16_control_is_not_correct(cell, tmp_path):
    """The control at a size a test run holds; on the card it runs at the
    cell's own size (benchmark/calibrate.py)."""
    from reference import engine as ref_engine

    c = spec.resolve(cell)
    e = spec.entry(c.mix["entry"]).Entry(c, SEED, "cpu", tmp_path / cell, TINY)
    e.make_inputs()
    worst = e.control(ref_engine.BFLOAT16)
    limits = c.limits["limits"]
    assert any(worst.value[k] > limits[k] for k in limits), worst.value


@pytest.mark.cuda
def test_rehearsal_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    res = tiny_run(CELLS[0], tmp_path, device="cuda", need_card=True)
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0
