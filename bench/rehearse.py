"""Rehearse a cell on the CPU, at the workload file's ``rehearsal`` sizes,
with the program's plain torch walks: every step of a run but the card.

    PYTHONPATH=src python3 bench/rehearse.py --workload <cell> [--seconds 2]

Times and rates printed here are the CPU's and name no device metric.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.run import run_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 7)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    res = run_cell(args.workload, args.seed, args.seconds, trace=False,
                   device="cpu", rehearse=True)
    print(json.dumps(res))
    return 0 if res["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
