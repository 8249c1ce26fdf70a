"""
The readings that a cell's correctness limits are set from, in one process:

    python3 benchmark/calibrate.py --workload bundle64.three --seeds 1 2 3 --calls 2 \
        --control-seeds 4 5 6 [--out FILE]

For each of `--seeds`: the cell's set-up (inputs drawn and written, the
warm-up calls), then `--calls` timed-path calls, judged as a run judges its
window. For each of `--control-seeds`: the inputs alone, and the reference
computed in the control's lower precision put in the program's place. Each
line printed is one seed's widest gap of each family; `--out` keeps them
all as JSON. The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from benchlib import device as dev  # noqa: E402
from benchlib import runner, spec  # noqa: E402


def readings(worst) -> dict:
    return {"value": dict(worst.value), "where": dict(worst.where)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", default="bfloat16", help="the control's precision (reference/engine.py)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=json.loads, default=None,
                    help='configuration keys overridden, as JSON (a small CPU rehearsal: {"taps": 4, "samples": 48000})')
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    cell = spec.resolve(args.workload)
    dev.cache_environment(spec.ROOT)
    import torch

    from reference import engine as ref_engine

    if args.device == "cuda":
        print(json.dumps(dev.require_cards(torch, int(cell.workload["chips"])) | {"power_limit": dev.power_limit()}),
              flush=True)
    runner.prepare_program(torch, args.device)
    Entry = spec.entry(cell.mix["entry"]).Entry
    out = {"workload": args.workload, "program": {}, "control": {}}
    for seed in args.seeds:
        entry = Entry(cell, seed, args.device, runner.workdir_for(args.workload), args.scale)
        entry.setup()
        records = [entry.call(entry.warm_calls + i) for i in range(args.calls)]
        t0 = time.perf_counter()
        judged = entry.judge(records)
        r = readings(judged["worst"]) | {"failed": judged["failed"], "judge_s": time.perf_counter() - t0,
                                          "errors": [rec["error"] for rec in records if "error" in rec]}
        out["program"][seed] = r
        print(json.dumps({"seed": seed, "program": r}), flush=True)
        entry.release()
        del entry
    for seed in args.control_seeds:
        entry = Entry(cell, seed, args.device, runner.workdir_for(args.workload), args.scale)
        entry.make_inputs()
        t0 = time.perf_counter()
        r = readings(entry.control(ref_engine.PRECISIONS[args.control])) | {"control_s": time.perf_counter() - t0}
        out["control"][seed] = r
        print(json.dumps({"seed": seed, "control": args.control, "readings": r}), flush=True)
        del entry
    for family in ("program", "control"):
        if out[family]:
            worst = {k: max(r["value"][k] for r in out[family].values())
                     for k in next(iter(out[family].values()))["value"]}
            least = {k: min(r["value"][k] for r in out[family].values())
                     for k in next(iter(out[family].values()))["value"]}
            print(json.dumps({family: {"largest": worst, "smallest": least}}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"calibrate: {time.perf_counter() - T_START:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
