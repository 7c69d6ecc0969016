"""The control of ``correct``: a run whose timed path is put at the
precision below the configuration's, which the check must call wrong.
The plain reference decodes each checked request's container with the
frequency table quantized at n - 1 bits, in the program's place.

    python3 bench/control.py --workload <cell> --seeds 21,22,23 [--seconds 2]

Prints each seed's compared numbers; exits 1 if any control came out
correct.  The benchmark's own runs never run it.
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
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    caught = True
    for seed in [int(s) for s in args.seeds.split(",")]:
        res = run_cell(args.workload, seed, args.seconds, trace=False,
                       control=True)
        caught &= not res["correct"]
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "checks": res["checks"]}), flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
