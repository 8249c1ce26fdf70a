"""The port's run-to-run comparison (audio_analysis_tpu_torch/report/compare.py)
against the JAX package's, and `bundle --compare` / `compare` end to end
on the CPU.

The comparison text is host-side formatting of the same two metrics
files, so it must be byte-identical to the JAX module's, and the flagged
line counts equal. The bundle runs compare the port's CLI against the JAX
CLI on the same bundle: the gate's exit codes match, and the `compare`
subcommand prints the same bytes for the same two metrics files.
"""

import json

import numpy as np
import pytest

pytest.importorskip("jax")

from audio_analysis_tpu.cli import analyse_cli as jax_cli  # noqa: E402
from audio_analysis_tpu.report import compare as jax_compare  # noqa: E402
from audio_analysis_tpu_torch.cli import analyse_cli as torch_cli  # noqa: E402
from audio_analysis_tpu_torch.io import write_bundle  # noqa: E402
from audio_analysis_tpu_torch.report import compare  # noqa: E402

SR = 48_000


def _metrics(taps, t30, ok=None, channels=("left", "right"), **extra):
    """A metrics dict in the bundle_metrics.json layout."""
    t30 = np.asarray(t30, np.float64)
    metrics = {
        "t30_rt60": t30.tolist(),
        "t30_ok": (np.ones_like(t30, bool) if ok is None else np.asarray(ok)).tolist(),
    }
    metrics.update({k: np.asarray(v).tolist() for k, v in extra.items()})
    return {"taps": list(taps), "channels": list(channels), "metrics": metrics}


def _missing_t30(m):
    del m["metrics"]["t30_rt60"]
    return m


_BASE = _metrics(["tap0", "tap1"], [[0.5, 0.5], [0.4, 0.4]])

# (current, previous, keyword arguments)
CASES = {
    "below_threshold": (_metrics(["tap0"], [[0.502, 0.5]]), _metrics(["tap0"], [[0.5, 0.5]]), {}),
    "above_threshold_signs": (
        _metrics(["tap0", "tap1"], [[0.5, 0.55], [0.36, 0.4]]), _BASE, {}
    ),
    "threshold_pct": (_metrics(["tap0", "tap1"], [[0.5, 0.55], [0.36, 0.4]]), _BASE, {"threshold_pct": 9.5}),
    "ok_flip_and_nan": (
        _metrics(["tap0"], [[0.5, float("nan")]], ok=[[True, False]]),
        _metrics(["tap0"], [[0.5, 0.5]], ok=[[True, True]]),
        {},
    ),
    "near_zero_noise": (_metrics(["tap0"], [[0.0001, 0.5]]), _metrics(["tap0"], [[0.0002, 0.5]]), {}),
    "missing_family": (_missing_t30(_metrics(["tap0"], [[0.5, 0.5]])), _metrics(["tap0"], [[0.5, 0.5]]), {}),
    "added_removed_taps": (
        _metrics(["tap0", "new"], [[0.5, 0.5], [0.4, 0.4]]),
        _metrics(["tap0", "gone"], [[0.5, 0.5], [0.4, 0.4]]),
        {},
    ),
    "channel_mismatch": (_metrics(["tap0"], [[0.5]], channels=("mono",)), _BASE, {}),
    "shape_changed": (
        _metrics(["tap0"], [[0.5, 0.5]], band_t30_rt60=[[[0.5, 0.4], [0.5, 0.4]]]),
        _metrics(["tap0"], [[0.5, 0.5]], band_t30_rt60=[[[0.5, 0.4, 0.3], [0.5, 0.4, 0.3]]]),
        {},
    ),
    "bands_and_stereo_joint": (
        _metrics(["tap0"], [[0.5, 0.5]], band_t30_rt60=[[[0.5, 0.4, 0.2], [0.5, 0.4, 0.3]]],
                 diff_median_corr0=[0.3]),
        _metrics(["tap0"], [[0.5, 0.5]], band_t30_rt60=[[[0.5, 0.4, 0.3], [0.5, 0.4, 0.3]]],
                 diff_median_corr0=[0.2]),
        {"previous_label": "`prev/reports`"},
    ),
    "max_lines": (
        _metrics(["tap0", "tap1"], [[0.6, 0.7], [0.8, 0.9]]), _BASE, {"max_lines": 2}
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_comparison_text_byte_identical_to_jax(case):
    current, previous, kwargs = CASES[case]
    text = compare.format_bundle_comparison(current, previous, **kwargs)
    assert text == jax_compare.format_bundle_comparison(current, previous, **kwargs)
    count = compare.count_flagged_in_text(text)
    assert count == jax_compare.count_flagged_in_text(text)
    assert (count == 0) == ("No changes above threshold." in text)


def test_unavailable_comparison_is_a_flagged_note(tmp_path):
    current = _metrics(["tap0"], [[0.5, 0.5]])
    text = compare.compare_section_for_index(current, tmp_path / "nowhere", 1.0)
    assert text == jax_compare.compare_section_for_index(current, tmp_path / "nowhere", 1.0)
    assert "Comparison unavailable" in text and compare.count_flagged_in_text(text) == 1


@pytest.mark.parametrize("where", ["file", "reports_dir", "bundle_root"])
def test_load_bundle_metrics_resolution(tmp_path, where):
    (tmp_path / "reports").mkdir()
    (tmp_path / "reports" / "bundle_metrics.json").write_text(json.dumps(_BASE))
    path = {
        "file": tmp_path / "reports" / "bundle_metrics.json",
        "reports_dir": tmp_path / "reports",
        "bundle_root": tmp_path,
    }[where]
    assert compare.load_bundle_metrics(path) == _BASE
    with pytest.raises(FileNotFoundError, match="bundle_metrics.json"):
        compare.load_bundle_metrics(tmp_path / "reports" / "nothing")


def _tap(rng, n, rt60):
    t = np.arange(n) / SR
    x = np.zeros((n, 2), np.float32)
    x[10:, :] = 0.05 * rng.standard_normal((n - 10, 2)) * 10 ** (-3 * t[: n - 10, None] / rt60)
    x[10, :] = 0.9
    return x


def _exit_code(main, argv):
    try:
        main(argv)
    except SystemExit as exc:
        return exc.code
    return 0


def test_bundle_compare_gate_matches_jax_cli(tmp_path, capsys):
    """bundle --no-plots --compare <its own reports dir> --fail-on-change:
    an unchanged rerun exits 0 with "No changes above threshold."; after a
    re-recorded tap both CLIs exit 3; the compare subcommand prints the same
    bytes from both CLIs for the port's two runs."""
    n = 1 << 14
    rng = np.random.default_rng(12)
    stable = _tap(rng, n, 0.25)
    root = write_bundle(tmp_path / "run", {"changed": _tap(rng, n, 0.25), "stable": stable}, SR)
    cpu = ["--device", "cpu"]
    torch_cli.main(["bundle", "--input", str(root), "--no-plots"] + cpu)
    jax_cli.main(["bundle", "--input", str(root), "--no-plots", "--reports-subdir", "reports_jax"])
    reports = root / "reports"
    (tmp_path / "first.json").write_text((reports / "bundle_metrics.json").read_text())

    gate = ["--compare", str(reports), "--fail-on-change"]
    assert _exit_code(torch_cli.main, ["bundle", "--input", str(root), "--no-plots"] + gate + cpu) == 0
    assert "No changes above threshold." in (reports / "bundle_report.md").read_text()

    write_bundle(tmp_path / "run", {"changed": _tap(rng, n, 0.4), "stable": stable}, SR)
    gate += ["--compare-threshold", "5"]
    assert _exit_code(torch_cli.main, ["bundle", "--input", str(root), "--no-plots"] + gate + cpu) == 3
    jax_gate = ["--compare", str(root / "reports_jax"), "--fail-on-change", "--compare-threshold", "5"]
    assert _exit_code(
        jax_cli.main, ["bundle", "--input", str(root), "--no-plots", "--reports-subdir", "reports_jax"] + jax_gate
    ) == 3
    index = (reports / "bundle_report.md").read_text()
    assert any(line.startswith("- changed [") and "t30_rt60" in line for line in index.splitlines())
    assert "- stable [" not in index

    capsys.readouterr()
    pair = [str(tmp_path / "first.json"), str(reports / "bundle_metrics.json"), "--fail-on-change"]
    assert _exit_code(torch_cli.main, ["compare"] + pair) == 3
    ours = capsys.readouterr().out
    assert _exit_code(jax_cli.main, ["compare"] + pair) == 3
    assert ours == capsys.readouterr().out
    assert "changed [left] t30_rt60" in ours

    # a previous run that cannot be read is a flagged note, so the gate fails
    bogus = ["--compare", str(tmp_path / "nowhere"), "--fail-on-change"]
    assert _exit_code(torch_cli.main, ["bundle", "--input", str(root), "--no-plots"] + bogus + cpu) == 3
    assert "Comparison unavailable" in (reports / "bundle_report.md").read_text()


def test_compare_subcommand_identical_runs_pass_the_gate(tmp_path, capsys):
    (tmp_path / "a.json").write_text(json.dumps(_metrics(["t"], [[0.5, 0.5]])))
    (tmp_path / "b.json").write_text(json.dumps(_metrics(["t"], [[0.5, 0.6]])))
    for main in (torch_cli.main, jax_cli.main):
        main(["compare", str(tmp_path / "a.json"), str(tmp_path / "a.json"), "--fail-on-change"])
        assert "No changes above threshold." in capsys.readouterr().out
        main(["compare", str(tmp_path / "a.json"), str(tmp_path / "b.json"), "--threshold", "50"])
        assert "No changes above threshold." in capsys.readouterr().out
