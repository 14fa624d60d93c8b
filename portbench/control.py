"""Readings for the limits of ``correct``, on the card, at a cell's own
size and load, several seeds in one process.

    python3 -m portbench.control --workload <name> --seconds <s> --seeds <n> ...

For each seed: a run of the cell as the benchmark makes it (set-up, the
window, the judge), whose numbers are the program's readings; then the
reference's lower-precision rows (``reference/<config>.py``,
``control_rows``) judged in the program's place, the control's readings.
The limits in ``configs/<config>.json`` lie between the largest program
reading and the smallest control reading.  One JSON line a seed.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from portbench import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    run.set_environment()
    import torch

    from portbench import spec
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card is available",
              file=sys.stderr)
        return 3
    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    for seed in args.seeds:
        res = run.run_cell(bench, cell, seed, args.seconds, 0, "cuda",
                           time.time(), control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "failed": res["failed"],
                          "program": {k: c["value"] for k, c in
                                      res["checks"].items()},
                          "control": res["control"],
                          "metrics": {k: m["value"] for k, m in
                                      res["metrics"].items()}}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
