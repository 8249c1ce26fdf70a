"""
One rank of the port's two-process multi-host CPU test
(tests/test_torch_multihost.py), on two CPU devices of its own.

    python tests/_torch_mh_worker.py <coordinator> <num_procs> <rank> <bundle> <out_json> [analyze|wrong_rate|one_device]

`analyze`: analyze_bundle_multi_host, then the report writer twice, the
second time comparing in place against the first (rank 0 checks that no
change is flagged); writes this rank's taps, T30s and aggregates as JSON.
`wrong_rate`: analyze_bundle_multi_host must raise ValueError; writes its
message. `one_device`: one CPU device a rank, every metric gathered, then
the report writer; writes this rank's taps, the gathered T30s and the
aggregates. The parent test gives the environment (no CUDA device,
GLOO_SOCKET_IFNAME=lo).
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch.distributed as dist  # noqa: E402

from audio_analysis_tpu_torch.engine import EngineConfig  # noqa: E402
from audio_analysis_tpu_torch.engine.distributed import (  # noqa: E402
    analyze_bundle_multi_host,
    initialize_multi_host,
    run_bundle_report_multi_host,
)

DEVICES = ["cpu", "cpu"]


def main() -> None:
    coordinator, num_procs, rank, bundle_root, out_json = sys.argv[1:6]
    mode = sys.argv[6] if len(sys.argv) > 6 else "analyze"
    rank = int(rank)
    initialize_multi_host(coordinator, int(num_procs), rank, timeout_s=120.0)
    config = EngineConfig(run_modal=False)
    try:
        if mode == "wrong_rate":
            try:
                analyze_bundle_multi_host(bundle_root, config, devices=DEVICES)
            except ValueError as exc:
                payload = {"rank": rank, "error": str(exc)}
            else:
                raise AssertionError("a wrong-rate tap did not raise")
        elif mode == "one_device":
            out = analyze_bundle_multi_host(bundle_root, config, devices=["cpu"], gather_global=True)
            index = run_bundle_report_multi_host(bundle_root, config, devices=["cpu"])
            assert (index is not None) == (rank == 0)
            payload = {
                "rank": rank,
                "local_tap_names": out["local_tap_names"],
                "global_t30_rt60": out["global_metrics"]["t30_rt60"].tolist(),
                "bundle_median_t30": float(out["bundle_median_t30"]),
                "bundle_valid_taps": int(out["bundle_valid_taps"]),
            }
        else:
            out = analyze_bundle_multi_host(bundle_root, config, devices=DEVICES)
            index = run_bundle_report_multi_host(bundle_root, config, devices=DEVICES)
            if rank == 0:
                metrics = json.loads((index.parent / "bundle_metrics.json").read_text())
                assert len(metrics["taps"]) == len(metrics["metrics"]["t30_rt60"]) > len(out["local_tap_names"])
                assert set(metrics) == {"taps", "channels", "metrics"}
            else:
                assert index is None
            again = run_bundle_report_multi_host(
                bundle_root, config, compare_to=str(Path(bundle_root) / "reports"), devices=DEVICES
            )
            if rank == 0:
                content = again.read_text()
                assert "## Changes vs" in content and "No changes above threshold." in content
            payload = {
                "rank": rank,
                "num_devices": int(out["num_devices"]),
                "local_tap_names": out["local_tap_names"],
                "t30_rt60": out["t30_rt60"].tolist(),
                "t30_ok": out["t30_ok"].tolist(),
                "bundle_median_t30": float(out["bundle_median_t30"]),
                "bundle_mean_early10": float(out["bundle_mean_early10"]),
                "bundle_valid_taps": int(out["bundle_valid_taps"]),
            }
    finally:
        dist.destroy_process_group()
    Path(out_json).write_text(json.dumps(payload))
    print("worker ok", rank)


if __name__ == "__main__":
    main()
