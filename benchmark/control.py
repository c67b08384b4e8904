"""Readings for the limits of a cell's output check: the program's numbers
and its control's over a list of seeds, in one process.

    python3 benchmark/control.py --workload <name> --seconds <s> --seeds 1 2 3 ...

The control is the plain reference computed one precision below the
configuration's (`control_precision`: float8 or int8 operands for bfloat16,
TF32 for float32) and put in the program's place: it is compared with the reference on the
program's recorded inputs, number by number. The benchmark's own runs never
run it. One JSON line per seed goes to standard output and to
`chiprun_out/control/<workload>.jsonl` when that directory can be made.
"""

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import faults, harness  # noqa: E402


def control_precision(bench: dict, workload: str) -> str:
    """TF32 for a float32 configuration; for a bfloat16 one float8, or int8
    for a training cell, whose norms-of-leaves numbers float8 does not
    separate from bfloat16 on every seed (PERF.md §4)."""
    cell = harness.find_cell(bench, workload)
    cfg = harness.load_json(harness.BENCH_DIR / "configs" / f"{cell['config']}.json")
    mix = harness.load_json(harness.BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    if cfg["dtype"] == "float32":
        return "tf32"
    return "int8" if mix["entry"] == "train" else "fp8"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "control"))
    ap.add_argument("--precision", choices=("fp8", "int8", "tf32"),
                    help="the control's precision (default: control_precision)")
    ap.add_argument("--fault", choices=faults.GENERATION + faults.TRAINING,
                    help="plant this fault under the timed path (benchmark/faults.py) and "
                         "read the program's numbers with it")
    args = ap.parse_args(argv)
    harness.cache_env()
    import torch

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    low = args.precision or control_precision(bench, args.workload)
    Path(args.out).mkdir(parents=True, exist_ok=True)
    path = Path(args.out) / f"{args.workload}.{args.fault or low}.jsonl"
    for seed in args.seeds:
        t = time.perf_counter()
        with getattr(faults, args.fault)() if args.fault else contextlib.nullcontext():
            res = harness.run_cell(args.workload, seed, args.seconds, False, control=low)
        line = {"seed": seed, "fault": args.fault, "program": res["numbers"],
                "control": res["control_checks"], "control_precision": low,
                "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        with open(path, "a") as f:
            f.write(json.dumps(line) + "\n")
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
