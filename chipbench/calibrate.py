"""Readings for a cell's output-check limit: the program's widest logit gap
and the control's, seed after seed in one process.

    python -m chipbench.calibrate --workload phi4-rag-closed --seconds 8 --seeds 1 2 3

Each seed runs the cell as ``chipbench.run`` does (the timed path at the
cell's own sizes and load, a short window, the same sample of requests),
then reads the control: the reference in float8 e4m3 products, put in the
program's place at the same prompts and served tokens.  The limit in
``checks/<workload>.json`` lies between the two sets of readings.  The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from chipbench.run import run_cell


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", default="fp8")
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="read the control on the first N seeds only (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chipbench.calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    n_control = len(args.seeds) if args.control_seeds is None else args.control_seeds
    for i, seed in enumerate(args.seeds):
        out = run_cell(args.workload, seed, args.seconds, False, torch.device("cuda", 0),
                       control=args.control if i < n_control else None)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": out["correct"],
                          "attempted": out["attempted"],
                          "logit_gap": out["check"]["logit_gap"]["value"],
                          "limit": out["check"]["logit_gap"]["limit"],
                          "control_gap": out.get("control_gap"),
                          "seconds": out["seconds"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
