"""Readings for the limits of `correct`: the program's numbers and the
control's over many seeds, in one process, at a cell's own size and load.

    python3 mdbench/control.py --workload <name> --seconds <s> \
        --seeds <n> [<n> ...]

For each seed: one run of the cell with a short window, the numbers
compared (check.numbers), and the same numbers with the reference at TF32
put in the program's place (check.control_outputs). One JSON line a seed
on standard output. The benchmark's own runs never run the control.
"""
import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(HERE.parent))
    import torch

    import harness
    import run as bench
    bench._caches()
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        result = harness.execute(
            args.workload, seed, args.seconds, False, device, control=True,
            log=lambda text: print("control: " + text, file=sys.stderr))
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": result["correct"], "failed": result["failed"],
            "attempted": result["attempted"],
            "program": {k: v for k, (v, _, _) in result["checks"].items()},
            "control": result["control"],
            "ns_per_day": result["ns_per_day"],
            "setup_s": result["setup_s"]}), flush=True)
    found = bench.forbidden_modules()
    if found:
        print("control: forbidden modules loaded: %s" % found,
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
