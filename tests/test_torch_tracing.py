"""The port's own tracing: the span helper (utils/timing.py span), the named
spans of a bundle call, and the engine step's block markers (ops/marker.py).

- Markers: a recording stand-in for `marker.mark` on a CPU step gives the
  block sequence of each toggle setting: the step's top, each block it
  runs (none for a block turned off) and the end.
- `span` with no profiler session enters no record_function and adds to
  `phases` what a pair of perf_counter calls around the block gives.
- Under a CPU torch.profiler session a bundle call's spans lie inside
  `aa.bundle` on its thread, also where the session records every thread,
  as `report --profile-dir`'s session (profile_trace) does; that session
  records a thread started inside it too.

The markers' kernels run on the card only: tests/test_torch_cuda.py checks
that every replayed chunk shows them in order.
"""

import json
import threading
from dataclasses import replace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audio_analysis_tpu_torch.engine import EngineConfig, analyze_batch
from audio_analysis_tpu_torch.io import native, write_bundle
from audio_analysis_tpu_torch.ops import marker
from audio_analysis_tpu_torch.report.engine_report import EngineBundleSettings, run_bundle_report_engine
from audio_analysis_tpu_torch.utils import timing

SR = 48_000
N = 1 << 14

ALL = ("align_decay", "bands", "fr_gd", "stft", "modal", "diffusion", "end")
TOGGLES = {
    "all_on": ({}, ALL),
    "no_bands": ({"run_bands": False}, ("align_decay", "fr_gd", "stft", "modal", "diffusion", "end")),
    "fr_only": ({"run_group_delay": False}, ALL),
    "group_delay_only": ({"run_fr": False}, ALL),
    "no_fr_no_group_delay": ({"run_fr": False, "run_group_delay": False},
                             ("align_decay", "bands", "stft", "modal", "diffusion", "end")),
    "no_stft": ({"run_stft": False}, ("align_decay", "bands", "fr_gd", "modal", "diffusion", "end")),
    "no_modal": ({"run_modal": False}, ("align_decay", "bands", "fr_gd", "stft", "diffusion", "end")),
    "no_diffusion": ({"run_diffusion": False}, ("align_decay", "bands", "fr_gd", "stft", "modal", "end")),
    "every_block_off": ({"run_bands": False, "run_fr": False, "run_group_delay": False, "run_stft": False,
                         "run_modal": False, "run_diffusion": False}, ("align_decay", "end")),
}

MAIN_SPANS = {
    "aa.bundle.probe", "aa.bundle.prepare", "aa.pipeline.prefetch", "aa.pipeline.decode_wait", "aa.pipeline.dispatch",
    "aa.pipeline.fetch", "aa.pipeline.unpack", "aa.report.markdown", "aa.pipeline.gather",
    "aa.report.json_build", "aa.report.write",
}


def _taps(count: int, n: int = N):
    rng = np.random.default_rng(3)
    t = np.arange(n) / SR
    taps = {}
    for i in range(count):
        x = np.zeros((n, 2), np.float32)
        x[64:] = 0.05 * rng.standard_normal((n - 64, 2)).astype(np.float32) * (10.0 ** (-3.0 * t[: n - 64, None] / 0.4))
        x[64] = 0.9
        taps[f"tap{i:02d}"] = x
    return taps


@pytest.mark.parametrize("case", sorted(TOGGLES))
def test_markers_follow_the_blocks_that_run(monkeypatch, case):
    toggles, expected = TOGGLES[case]
    seen = []
    monkeypatch.setattr(marker, "mark", lambda block, device: seen.append((block, device.type)))
    rng = np.random.default_rng(0)
    samples = torch.from_numpy((0.1 * rng.standard_normal((2, 2, N))).astype(np.float32))
    lengths = torch.tensor([N, N - 1000], dtype=torch.int32)
    out = analyze_batch(samples, lengths, replace(EngineConfig(), **toggles))
    assert [b for b, _d in seen] == list(expected)
    assert {d for _b, d in seen} == {"cpu"}
    assert "start_index" in out


def test_a_marker_on_the_cpu_launches_nothing_and_names_a_known_block(monkeypatch):
    def no_library():
        raise AssertionError("a CPU marker loaded the kernel library")

    monkeypatch.setattr(marker._build, "library", no_library)
    for block in marker.BLOCKS:
        marker.mark(block, torch.device("cpu"))
    with pytest.raises(ValueError):
        marker.mark("no_such_block", torch.device("cpu"))


class _Clock:
    """perf_counter stand-in: returns the scripted values in turn."""

    def __init__(self, *values):
        self.values = list(values)

    def __call__(self):
        return self.values.pop(0)


@pytest.mark.parametrize(
    "phases,key,clock,expected",
    [
        (None, None, (1.0, 1.5), None),
        ({}, "fetch_s", (2.0, 2.25), {"fetch_s": 0.25}),
        ({"fetch_s": 0.5, "probe_s": 0.1}, "fetch_s", (3.0, 3.125), {"fetch_s": 0.625, "probe_s": 0.1}),
    ],
    ids=["no_phases", "new_key", "accumulates"],
)
def test_span_without_a_session_only_times(monkeypatch, phases, key, clock, expected):
    def refused(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler session")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(timing.time, "perf_counter", _Clock(*clock))
    assert not timing.profiling()
    with timing.span("aa.test", phases, key):
        pass
    assert phases == expected


def test_span_times_a_block_that_raises_and_re_raises():
    phases = {}
    with pytest.raises(ValueError):
        with timing.span("aa.test", phases, "x_s"):
            raise ValueError("inside")
    assert phases["x_s"] >= 0.0


def test_span_inside_a_session_is_a_record_function_range():
    phases = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert timing.profiling()
        with timing.span("aa.outer", phases, "outer_s"):
            with timing.span("aa.inner"):
                torch.ones(4).sum()
    assert not timing.profiling()
    events = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name().startswith("aa.")}
    assert set(events) == {"aa.outer", "aa.inner"}
    outer, inner = events["aa.outer"], events["aa.inner"]
    assert outer.start_ns() <= inner.start_ns() and inner.end_ns() <= outer.end_ns()
    assert phases["outer_s"] > 0.0


def _bundle(tmp_path, taps=3):
    return write_bundle(tmp_path / "bundle", _taps(taps), SR)


def _settings(**kw):
    return EngineBundleSettings(config=replace(EngineConfig(), band_mode="three"), chunk_taps=1, **kw)


def _aa_events(prof):
    return [e for e in prof.profiler.kineto_results.events() if e.name().startswith("aa.")]


@pytest.mark.parametrize("pipelined", [True, False], ids=["pcm16_pipeline", "float_batch"])
def test_bundle_call_spans_nest_under_aa_bundle_on_the_main_thread(tmp_path, monkeypatch, pipelined):
    if pipelined and not native.ensure_built():
        pytest.skip("the pipelined PCM16 path needs the native decoder (make -C cpp)")
    if not pipelined:
        from audio_analysis_tpu_torch.report import engine_report

        monkeypatch.setattr(engine_report, "open_bundle_chunks_i16", lambda root: None)
        monkeypatch.setattr(engine_report, "load_bundle_batch_i16", lambda root: None)
    root = _bundle(tmp_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_bundle_report_engine(root, _settings(), device="cpu")
    events = _aa_events(prof)
    bundles = [e for e in events if e.name() == "aa.bundle"]
    assert len(bundles) == 1
    call = bundles[0]
    inner = [e for e in events if e.name() != "aa.bundle"]
    names = {e.name() for e in inner}
    assert MAIN_SPANS <= names, MAIN_SPANS - names
    for e in inner:
        assert e.start_thread_id() == call.start_thread_id(), e.name()
        assert call.start_ns() <= e.start_ns() and e.end_ns() <= call.end_ns(), e.name()
    phases = json.loads((root / "reports" / "bundle_metrics.json").read_text())["phases"]
    fed = {"probe_s": "aa.bundle.probe", "json_s": "aa.report.json_build"}
    if pipelined:
        # the summaries of each chunk are written by the pipeline's callback
        fed.update(decode_wait_s="aa.pipeline.decode_wait", h2d_dispatch_s="aa.pipeline.dispatch",
                   fetch_s="aa.pipeline.fetch", markdown_s="aa.pipeline.callback")
        assert "aa.pipeline.callback" in names
    else:
        fed.update(markdown_s="aa.report.markdown")
    assert set(fed) | {"compute_total_s"} <= set(phases)
    # each key holds the summed time of the spans that feed it, rounded to
    # 0.1 ms (the trace's durations add the ranges' own entry and exit)
    dur = {}
    for e in inner:
        dur[e.name()] = dur.get(e.name(), 0.0) + e.duration_ns() * 1e-9
    for key, name in fed.items():
        assert phases[key] == pytest.approx(dur[name], abs=5e-3), key


def test_a_session_of_every_thread_still_records_the_main_thread_spans(tmp_path):
    # torch's thread-local profiler flag reads False under such a session;
    # span gates on the process-wide one
    if not native.ensure_built():
        pytest.skip("the pipelined PCM16 path needs the native decoder (make -C cpp)")
    root = _bundle(tmp_path)
    all_threads = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=all_threads) as prof:
        assert timing.profiling()
        run_bundle_report_engine(root, _settings(), device="cpu")
    events = _aa_events(prof)
    main = next(e for e in events if e.name() == "aa.bundle").start_thread_id()
    assert MAIN_SPANS | {"aa.pipeline.callback"} <= {e.name() for e in events}
    assert all(e.start_thread_id() == main for e in events)
    assert len([e for e in events if e.name() == "aa.report.markdown"]) == 3  # one a chunk


def test_profile_trace_records_the_main_thread_and_a_thread_it_starts(tmp_path):
    def on_thread():
        torch.ones(8).cumsum(0)

    with timing.profile_trace(str(tmp_path / "prof")):
        with timing.span("aa.test"):
            torch.ones(8).sum()
        t = threading.Thread(target=on_thread)
        t.start()
        t.join()
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    tid = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X":
            tid.setdefault(e.get("name"), set()).add(e.get("tid"))
    assert "aa.test" in tid, "a span inside profile_trace is missing from its trace"
    assert "aten::cumsum" in tid, "the started thread's op is missing from the trace"
    assert tid["aten::cumsum"].isdisjoint(tid["aa.test"])
