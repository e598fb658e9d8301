"""The readings that a cell's limits are set from, on the card:

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
        --seconds 3

For each seed, in one process (the app is built once): a run of the
cell's timed path with a window of ``--seconds`` (``run.measure``), the
program's readings (``run.judge``), and the control's: the plain reference
computed in bfloat16 in the program's place, from the same states and
frames (``reference.check.control_gaps``). One JSON line a seed. Not part
of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from benchmark.reference import check

    spec = run.load_spec()
    cell = run.Cell(spec, run.workload(spec, args.workload), args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        m = run.measure(cell, seed, args.seconds, False)
        t = time.perf_counter()
        readings = run.judge(cell, m)
        judge_s = time.perf_counter() - t
        control = check.control_gaps(m["states"], m["kept"], cell.config,
                                     cell.mix)
        print(json.dumps(dict(seed=seed, steps=m["steps"],
                              window_s=m["window_s"], judge_s=judge_s,
                              program=readings, control=control)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
