"""BENCHMARK.json against the benchmark's contract, and the harness's
finding of every file by name."""

import json
import re
import shutil
from pathlib import Path

import pytest

from benchlib import spec

ROOT = spec.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
TEXT = re.compile(r"[^\t\n]{1,200}")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion|per_tok")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(TEXT.fullmatch(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p) and ".." not in p and not p.startswith("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    for word in BENCH["command"][1:]:
        if (ROOT / word).exists():
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_full_check_fits_with_24_cells():
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_entries_and_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    names = set()
    for group, allowed in keys.items():
        assert 1 <= len(BENCH[group])
        for e in BENCH[group]:
            extra = set(e) - allowed - ({"workloads"} if group in ("end_to_end", "per_layer") else set())
            assert not extra and allowed <= set(e), (group, e["name"], extra)
            assert NAME.fullmatch(e["name"]), e["name"]
            assert e["name"] not in names
            names.add(e["name"])
            for k in {"configs": ("why", "source"), "workloads": ("why",), "per_layer": ("layer",)}.get(group, ()):
                assert TEXT.fullmatch(e[k]), (e["name"], k)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_configs_cells_and_metrics():
    cfg_names = {c["name"] for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert cfg_names == used
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and not any(WIDTH.search(k) for k in c["reduced"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and NAME.fullmatch(w["traffic"]) and TEXT.fullmatch(w["why"])
        cell = spec.resolve(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_every_cell_resolves_to_its_files():
    assert spec.missing_files(BENCH) == {}


def test_a_new_cell_is_new_files_only(tmp_path):
    """Copy the benchmark, add a configuration, a mix, a metric and a cell
    as new files and one new entry each in BENCHMARK.json: the harness
    finds them with no other file edited."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    w = bench["workloads"][0]
    old_cfg = spec.resolve(w["name"]).config_entry
    (tmp_path / "benchmark/configs/new_cfg.json").write_text(
        (ROOT / old_cfg["file"]).read_text())
    (tmp_path / "benchmark/traffic/new_mix.json").write_text(
        (ROOT / "benchmark/traffic" / f"{w['traffic']}.json").read_text())
    (tmp_path / "benchmark/metrics/new_metric.py").write_text("def read(ctx):\n    return 1.0\n")
    (tmp_path / "benchmark/limits/new.cell.json").write_text(
        (ROOT / "benchmark/limits" / f"{w['name']}.json").read_text())
    bench["configs"].append(dict(old_cfg, name="new_cfg", file="benchmark/configs/new_cfg.json"))
    bench["workloads"].append(dict(w, name="new.cell", config="new_cfg", traffic="new_mix"))
    bench["per_layer"].append({"name": "new_metric", "unit": "ms", "better": "lower", "source": "host_clock",
                               "layer": "device", "moves": "setup_s", "workloads": ["new.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.resolve("new.cell", tmp_path)
    assert cell.config_entry["name"] == "new_cfg" and cell.mix == spec.resolve(w["name"]).mix
    assert [m["name"] for m in cell.per_layer] == ["new_metric"]
    assert spec.metric_reader("new_metric", tmp_path).read(None) == 1.0
    assert spec.missing_files(bench, tmp_path) == {}
    (tmp_path / "benchmark/metrics/new_metric.py").unlink()
    assert spec.missing_files(bench, tmp_path) == {"new.cell": ["benchmark/metrics/new_metric.py"]}


def test_limits_sit_between_their_readings():
    for w in BENCH["workloads"]:
        lim = json.loads((ROOT / "benchmark/limits" / f"{w['name']}.json").read_text())
        for name, limit in lim["limits"].items():
            lower, upper = lim["readings"][name]["program_largest"], lim["readings"][name]["control_smallest"]
            assert lower < limit < upper, (w["name"], name)
            assert upper >= 3 * lower, (w["name"], name)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_no_cell_without_config_in_file(cell):
    c = spec.resolve(cell)
    assert c.config["name"] == c.config_entry["name"]
    assert c.config["source"] == c.config_entry["source"]
    assert c.config["reduced"] == c.config_entry["reduced"]
