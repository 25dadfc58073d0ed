"""The correctness check's control, on the card: for each seed, one run
of a cell at its own size and load (a short window), whose outputs are
compared twice with the plain reference: the program's, and the
control's, the reference put in the program's place in the next lower
precision of the configuration (FP32: the plaintext arithmetic mod
2^(k/2)). The check is sound where every program reading is within its
limit and the control's fail it.

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

Prints one JSON line a seed: {"seed", "program": {name: value},
"control": {name: value}, "limits": {name: limit}}. The benchmark's own
runs do not run it.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        res, _ = harness.run_cell(ROOT, args.workload, seed, args.seconds, False,
                                  time.perf_counter(), control=True)
        print(json.dumps({"seed": seed,
                          "program": {k: v["value"] for k, v in res["compared"].items()},
                          "control": res["control"],
                          "limits": {k: v["limit"] for k, v in res["compared"].items()},
                          "attempted": res["attempted"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
