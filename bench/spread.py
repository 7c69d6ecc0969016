"""Run a cell once a seed, each run its own process, and print every run's
metrics and checks, then each metric's median and quartile spread
((Q3 - Q1) / median, ``statistics.quantiles(n=4)``), the number a bound is
set from.

    python3 bench/spread.py --workload <cell> --seeds 11,12,13 \\
        [--seconds 10] [--trace 0] [--out chiprun_out/<file>.jsonl]

``--seconds`` defaults to BENCHMARK.json's ``run_seconds``.  Each run's
result line, with its seed and wall time, is appended to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench.stats import quartile_spread  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    seconds = args.seconds or bench["run_seconds"]
    values: dict = {}
    ok = True
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
             args.workload, "--seed", str(seed), "--seconds", str(seconds),
             "--trace", str(args.trace)],
            capture_output=True, text=True,
            cwd=ROOT)
        wall = time.perf_counter() - t
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            ok = False
            print(f"seed {seed}: exit {proc.returncode} after {wall:.1f} s\n"
                  f"{proc.stderr[-3000:]}", flush=True)
            continue
        res = json.loads(lines[-1])
        res["seed"], res["wall_s"] = seed, wall
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(res) + "\n")
        ok &= res["correct"]
        ms = {k: v["value"] for k, v in res["metrics"].items()}
        for k, v in ms.items():
            values.setdefault(k, []).append(v)
        print(f"seed {seed}: correct={res['correct']} wall {wall:.1f} s "
              f"{json.dumps(ms)} checks "
              f"{json.dumps({k: c['value'] for k, c in res['checks'].items()})}"
              f" peak {res['device']['memory_peak_bytes']}"
              f" busy/window {res['device'].get('busy_s')}"
              f"/{res['device'].get('window_s')}", flush=True)
    for k, v in values.items():
        if len(v) >= 3:
            print(f"{k}: median {statistics.median(v)!r} spread "
                  f"{quartile_spread(v)!r} over {len(v)} runs", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
