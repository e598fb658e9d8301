"""A/B of the port's headline line between checkouts, on the card.

    python scripts/headline_ab.py CHECKOUT [CHECKOUT ...]

Runs ``python -m tpufluid_torch.bench`` (no flag: the headline run) once in
each checkout, in the order given, each in its own process, and prints each
run's particle-steps/s, its sigma and wall seconds, then the median rate of
each checkout and the card's name and power limit. A checkout from before the
headline's parity refresh prints the headline alone; a later one refreshes
engine parity first (its report on stderr). Name the checkouts in an order
such as A B B A A B, so that both sides see the same drift of the shared
host. Each checkout builds its own kernels on its first run, before the
harness times anything. Exits non-zero if a run fails.
"""

import json
import statistics
import subprocess
import sys
import time


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "?"


def headline(checkout: str) -> dict:
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "tpufluid_torch.bench"],
                         cwd=checkout, capture_output=True, text=True,
                         timeout=900)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise SystemExit(f"{checkout}: exit {out.returncode}\n"
                         f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    lines = out.stdout.strip().splitlines()
    rec = json.loads(lines[-1])
    return dict(checkout=checkout, value=rec["value"], sigma=rec["sigma"],
                parity_ok=rec.get("parity_ok"), stdout_lines=len(lines),
                wall_s=wall)


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    card = card_line()
    runs = []
    for checkout in argv:
        r = headline(checkout)
        runs.append(r)
        print(f"{checkout}: {r['value']:.6g} particle-steps/s (sigma "
              f"{r['sigma']:.4g}), parity_ok {r['parity_ok']}, wall "
              f"{r['wall_s']:.1f} s ({card})", flush=True)
    medians = {c: statistics.median(r["value"] for r in runs
                                    if r["checkout"] == c)
               for c in dict.fromkeys(argv)}
    print(json.dumps(dict(card=card, runs=runs, medians=medians)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
