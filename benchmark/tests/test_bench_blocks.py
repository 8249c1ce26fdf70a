"""The readers of the program's own markers and spans (benchlib/blocks.py) on
hand-built traces: the block split of two chunks, the write span, the idle
share that no span names, and a trace without markers or spans (an older
program) reading nothing."""

from types import SimpleNamespace

import pytest

from benchlib import blocks, spec
from benchlib.trace import TraceView

BLOCKS = ("align_decay", "bands", "fr_gd", "stft", "modal", "diffusion")
NAMED = ["benchmark_window", "benchmark_call"]


def two_chunks():
    """One call of two chunks. Each chunk: 7 markers 1 us long, block work
    after each (bands as two overlapping kernels), an upload on the side
    stream across the bands block, and the pack after the end marker."""
    device = []
    starts = {"align_decay": 0.0, "bands": 0.1, "fr_gd": 0.3, "stft": 0.4, "modal": 0.5, "diffusion": 0.7,
              "end": 0.8}
    work = {"align_decay": [(0.01, 0.09)], "bands": [(0.11, 0.20), (0.15, 0.29)], "fr_gd": [(0.31, 0.35)],
            "stft": [(0.41, 0.45)], "modal": [(0.51, 0.69)], "diffusion": [(0.71, 0.79)]}
    for base in (1.0, 2.0):
        for name, t in starts.items():
            device.append((f"aa_mark_{name}", base + t, base + t + 1e-6))
        for name, spans in work.items():
            device += [(f"kernel_{name}", base + a, base + b) for a, b in spans]
        device.append(("Memcpy HtoD (Pinned -> Device)", base + 0.12, base + 0.6))
        device.append(("pack", base + 0.81, base + 0.82))
    spans = [("benchmark_window", 0.0, 10.0), ("benchmark_call", 0.0, 4.0), ("aa.bundle", 0.0, 4.0),
             ("aa.report.write", 3.5, 3.75), ("aa.report.write", 3.75, 3.8)]
    return TraceView((0.0, 10.0), device, spans, NAMED)


def ctx(view, calls=1):
    return SimpleNamespace(trace=view, records=[{}] * calls)


@pytest.mark.parametrize("block,ms", [("align_decay", 160.0), ("bands", 360.0), ("fr_gd", 80.0), ("stft", 80.0),
                                      ("modal", 360.0), ("diffusion", 160.0)])
def test_a_block_is_the_work_from_its_marker_to_the_next(block, ms):
    assert blocks.block_device_ms(ctx(two_chunks()), block) == pytest.approx(ms)
    assert blocks.block_device_ms(ctx(two_chunks(), calls=2), block) == pytest.approx(ms / 2)


def test_the_blocks_leave_out_uploads_markers_and_the_pack():
    view = two_chunks()
    total = sum(blocks.block_device_ms(ctx(view), b) for b in BLOCKS)
    assert total == pytest.approx(1e3 * 2 * (0.08 + 0.18 + 0.04 + 0.04 + 0.18 + 0.08))
    assert total < 1e3 * view.busy_s()


def test_write_span_is_summed_over_the_calls():
    assert blocks.span_ms(ctx(two_chunks()), "aa.report.write") == pytest.approx(300.0)
    assert blocks.span_ms(ctx(two_chunks(), calls=3), "aa.report.write") == pytest.approx(100.0)


def test_idle_share_inside_the_call_that_no_span_names():
    device = [("k", 1.0, 2.0), ("k", 3.0, 3.5)]
    spans = [("benchmark_window", 0.0, 4.0), ("benchmark_call", 0.0, 4.0), ("aa.bundle", 0.0, 4.0),
             ("aa.bundle.probe", 0.0, 0.5), ("aa.report.write", 3.5, 4.0), ("aten::copy_", 2.0, 3.0)]
    view = TraceView((0.0, 4.0), device, spans, NAMED)
    # idle in the call: 0-1, 2-3, 3.5-4 (2.5 s); named: 0-0.5 and 3.5-4
    assert blocks.idle_unnamed_share(ctx(view)) == pytest.approx(100.0 * 1.5 / 2.5)
    # the harness names a gap by the innermost span, the program's included
    names = {name for name, _s in view.breakdown()["idle_gaps"]}
    assert "benchmark_window > benchmark_call > aa.report.write" in names


def test_an_older_program_reads_nothing():
    device = [("kernel", 1.0, 2.0), ("Memcpy HtoD (Pinned -> Device)", 0.5, 1.0)]
    view = TraceView((0.0, 3.0), device, [("benchmark_window", 0.0, 3.0), ("benchmark_call", 0.0, 3.0)], NAMED)
    for block in BLOCKS:
        assert blocks.block_device_ms(ctx(view), block) is None
    assert blocks.span_ms(ctx(view), "aa.report.write") is None
    assert blocks.idle_unnamed_share(ctx(view)) is None
    assert blocks.block_device_ms(ctx(None), "bands") is None
    assert blocks.idle_unnamed_share(ctx(None)) is None


def test_every_new_reader_is_declared_for_its_cell():
    bench = spec.load_benchmark()
    names = {m["name"]: m for m in bench["per_layer"]}
    for suffix, cell in (("bundle", "bundle64.three"), ("third", "bundle64.third")):
        wanted = [f"engine.{b}_device_ms.{suffix}" for b in BLOCKS]
        wanted += [f"engine_report.write_ms.{suffix}", f"device.idle_unnamed_share.{suffix}"]
        for name in wanted:
            assert names[name]["workloads"] == [cell]
            reader = spec.metric_reader(name)
            assert reader.read(ctx(two_chunks())) is not None, name
