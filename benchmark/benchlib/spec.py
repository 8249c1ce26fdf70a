"""
The benchmark's data: BENCHMARK.json at the checkout's root, and the files
it names by convention, each found by its name and nothing else:

- benchmark/configs/<config>.json   the `file` of a configuration
- benchmark/traffic/<mix>.json      a traffic mix: the entry it drives and
                                    its parameters
- benchmark/benchlib/entries/<entry>.py   the code of an entry kind
- benchmark/metrics/<metric>.py     a metric's reader, end-to-end or per layer
- benchmark/limits/<workload>.json  the limits of a cell's correctness check
- benchmark/rooflines/<kernel>.py   a kernel's operation and byte count

No file lists the others, so a new cell, mix, configuration or metric is
new files only.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class SpecError(Exception):
    """The benchmark's data does not resolve."""


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    config_entry: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"{path} is missing")
    return json.loads(path.read_text())


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SpecError(f"no {what} named {name!r} in BENCHMARK.json")


def _json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise SpecError(f"{what} {path} is missing")
    return json.loads(path.read_text())


def metric_applies(metric: dict, workload: str, e2e_names: List[str]) -> bool:
    """A metric with `workloads` is read in those cells; a per-layer metric
    without it in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def resolve(workload: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else load_benchmark(root)
    w = _by_name(bench["workloads"], workload, "workload")
    centry = _by_name(bench["configs"], w["config"], "configuration")
    config = _json(root / centry["file"], "configuration file")
    mix = _json(root / "benchmark" / "traffic" / f"{w['traffic']}.json", "traffic mix")
    e2e = [m for m in bench["end_to_end"] if metric_applies(m, workload, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if metric_applies(m, workload, names)]
    limits = _json(root / "benchmark" / "limits" / f"{workload}.json", "limits file")
    return Cell(workload, w, config, centry, mix, e2e, per_layer, limits)


def load_module(path: Path, name: str):
    """Import one file of the benchmark by its path (metric names hold dots,
    so they are not importable by name)."""
    if not path.is_file():
        raise SpecError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, root: Path = ROOT):
    return load_module(root / "benchmark" / "metrics" / f"{name}.py", f"benchmetric_{name.replace('.', '_')}")


def roofline(kernel: str, root: Path = ROOT):
    return load_module(root / "benchmark" / "rooflines" / f"{kernel}.py", f"benchroofline_{kernel}")


def entry(kind: str, root: Path = ROOT):
    return load_module(root / "benchmark" / "benchlib" / "entries" / f"{kind}.py", f"benchentry_{kind}")


def missing_files(bench: dict, root: Path = ROOT) -> Dict[str, List[str]]:
    """Every file a cell of `bench` would need and that is not there."""
    out: Dict[str, List[str]] = {}
    for w in bench["workloads"]:
        need = []
        try:
            cell = resolve(w["name"], root, bench)
        except SpecError as exc:
            out[w["name"]] = [str(exc)]
            continue
        need.append(root / "benchmark" / "benchlib" / "entries" / f"{cell.mix['entry']}.py")
        need += [root / "benchmark" / "metrics" / f"{m['name']}.py" for m in cell.end_to_end + cell.per_layer]
        miss = [str(p.relative_to(root)) for p in need if not p.is_file()]
        if miss:
            out[w["name"]] = miss
    return out
