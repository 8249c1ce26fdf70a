"""
The traced window: torch.profiler over the calls of a `--trace 1` run, with
the harness's own spans (record_function) around each call and, where the
mix names them, around functions of the program, wrapped from outside for
the traced run only. After the window the trace is reduced to device
intervals, kernel events and host spans on one clock.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from benchlib import stats


@dataclass
class TraceView:
    window: Tuple[float, float]  # seconds on the trace's clock
    device: List[Tuple[str, float, float]]  # (name, start, end) of every device event
    spans: List[Tuple[str, float, float]]  # host spans: harness, wrapped program functions, torch ops
    named: List[str] = field(default_factory=list)  # the names of the harness's and wrapped spans

    def device_intervals(self) -> List[Tuple[float, float]]:
        return [(a, b) for _n, a, b in self.device]

    def busy_s(self) -> float:
        return stats.busy(self.device_intervals(), *self.window)

    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self, fragment: str) -> List[Tuple[str, float, float]]:
        return [e for e in self.device if fragment in e[0]]

    def gap_name(self, lo: float, hi: float) -> str:
        """The stack of spans the host was in at the middle of a device gap:
        the harness's and wrapped spans, then the innermost torch op."""
        mid = 0.5 * (lo + hi)
        inside = [s for s in self.spans if s[1] <= mid <= s[2]]
        named = sorted((s for s in inside if s[0] in self.named), key=lambda s: s[1])
        ops = sorted((s for s in inside if s[0] not in self.named), key=lambda s: s[1])
        parts = [s[0] for s in named] + ([ops[-1][0]] if ops else [])
        return " > ".join(parts) if parts else "host between spans"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_name: Dict[str, float] = {}
        for name, a, b in self.device:
            lo, hi = max(a, self.window[0]), min(b, self.window[1])
            if hi > lo:
                by_name[name] = by_name.get(name, 0.0) + (hi - lo)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(stats.gaps(self.device_intervals(), *self.window), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[self.gap_name(a, b), b - a] for a, b in idle]}


def _wrap(fn, name: str):
    import torch

    @functools.wraps(fn)
    def traced(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return traced


@contextlib.contextmanager
def program_spans(targets: List[str]):
    """Wrap each `module:function` of the program in a span of that
    function's name while the block runs; put the originals back after."""
    saved = []
    try:
        for target in targets:
            mod_name, attr = target.split(":")
            mod = importlib.import_module(mod_name)
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, _wrap(getattr(mod, attr), attr))
        yield [t.split(":")[1] for t in targets]
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def read_profile(prof, window_name: str, named: List[str]) -> TraceView:
    """Device events and host spans of a finished torch.profiler session;
    the window is the harness span `window_name`."""
    device, spans = [], []
    window = None
    events = list(prof.profiler.kineto_results.events())
    base = min((e.start_ns() for e in events), default=0)  # seconds from here keep their nanoseconds
    names = {window_name, *named}
    for e in events:
        kind = e.device_type().name
        lo = (e.start_ns() - base) * 1e-9
        hi = lo + e.duration_ns() * 1e-9
        if kind == "CUDA":
            # a span's mirror on the device's timeline is no device work
            if not (e.name() in names or getattr(e, "is_user_annotation", lambda: False)()):
                device.append((e.name(), lo, hi))
        elif kind == "CPU":
            if e.name() == window_name:
                window = (lo, hi)
            spans.append((e.name(), lo, hi))
    if window is None:
        raise RuntimeError(f"the trace holds no span {window_name!r}")
    return TraceView(window, device, spans, [window_name] + named)
