"""Runs of a cell, one process each, and the spreads that set its bounds.

    python3 bench_port/spreads.py --workload <cell> --seeds 1,2,3,4,5,6 --sets 2 --out runs.jsonl
    python3 bench_port/spreads.py --read runs.jsonl

The first form runs `run.py` once a process for each seed of each set (the
same seeds in every set), appending one JSON line a run to --out (the
run's exit code, wall and result line). The second prints, for each cell
and metric, each set's median and spread: the distance between the first
and third quartiles (`statistics.quantiles(values, n=4)`) over the median,
and the same with each set's run farthest from its median left out.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def without_farthest(values) -> list:
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return [v for i, v in enumerate(values) if i != far]


def run(cell: str, seeds, sets: int, trace: int, seconds: str, out: str) -> None:
    with open(out, "a") as f:
        for st in range(sets):
            for seed in seeds:
                t0 = time.time()
                p = subprocess.run([sys.executable, "bench_port/run.py", "--workload", cell,
                                    "--seed", str(seed), "--seconds", seconds,
                                    "--trace", str(trace)],
                                   cwd=ROOT, capture_output=True, text=True)
                lines = p.stdout.strip().splitlines()
                rec = {"cell": cell, "set": st, "seed": seed, "trace": trace, "rc": p.returncode,
                       "elapsed": time.time() - t0,
                       "result": json.loads(lines[-1]) if lines else None,
                       "stderr_tail": p.stderr[-2000:]}
                f.write(json.dumps(rec) + "\n")
                f.flush()
                metrics = (rec["result"] or {}).get("metrics", {})
                print(cell, st, seed, p.returncode, round(rec["elapsed"], 1),
                      (rec["result"] or {}).get("correct"),
                      {k: v["value"] for k, v in metrics.items()}, flush=True)


def read(path: str) -> None:
    by = defaultdict(lambda: defaultdict(list))
    for line in open(path):
        rec = json.loads(line)
        if rec["result"] is None:
            print("no result:", rec["cell"], rec["seed"], rec["rc"])
            continue
        for k, v in rec["result"]["metrics"].items():
            by[(rec["cell"], rec["trace"], k)][rec["set"]].append(v["value"])
    for (cell, trace, metric), sets in sorted(by.items()):
        for st, vals in sorted(sets.items()):
            if len(vals) < 3:
                continue
            print(cell, f"trace={trace}", metric, f"set {st}", f"n={len(vals)}",
                  f"median={statistics.median(vals)!r}", f"spread={spread(vals):.4f}",
                  f"spread_without_farthest={spread(without_farthest(vals)):.4f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seeds", help="comma-separated")
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--seconds", default=None, help="default: BENCHMARK.json's run_seconds")
    ap.add_argument("--out")
    ap.add_argument("--read")
    a = ap.parse_args()
    if a.read:
        read(a.read)
        return 0
    seconds = a.seconds or str(json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"])
    run(a.workload, [int(s) for s in a.seeds.split(",")], a.sets, a.trace, seconds, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
