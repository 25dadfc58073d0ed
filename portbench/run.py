"""Run one cell of the benchmark once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics), `device`,
with --trace 1 `breakdown`, and last `compared`: each number the
correctness check compared, beside its limit (also the last lines of
standard error). Exits non-zero, with no result, without a CUDA card (or
with fewer cards than the cell asks for), when the program is missing, or
when JAX or the JAX package got loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout (the
    # program builds its kernels into build/cofhe_tpu_torch by itself)
    cache = os.path.join(ROOT, "build", "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path.insert(0, ROOT)
    if not os.path.isdir(os.path.join(ROOT, "cofhe_tpu_torch")):
        print("portbench: the program (cofhe_tpu_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    import torch

    from portbench import harness

    bench = harness.load_json(ROOT, "BENCHMARK.json")
    wl, _ = harness.find_cell(bench, args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < wl["chips"]:
        print(harness.cards_missing(args.workload, wl["chips"], have), file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result, notes = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                                     bool(args.trace), T_START)
    lat = sorted(notes["latencies_s"])
    print(f"portbench: set-up seconds by piece {notes['setup_pieces_s']}; memory peak "
          f"bytes by card {notes['memory_peak_bytes_by_card']}", file=sys.stderr)
    print(f"portbench: {len(lat)} requests, latency s min {lat[0]:.4f} median "
          f"{lat[len(lat) // 2]:.4f} max {lat[-1]:.4f}" if lat else
          "portbench: no request completed", file=sys.stderr)
    if args.trace:
        print(f"portbench: device busy s by card {notes['busy_s_by_card']} of a "
              f"{result['device']['window_s']:.4f} s window", file=sys.stderr)
        print(f"portbench: peaks 3.35 TB/s, int32 16.75 Tops/s, int8 1979 Tops/s; "
              f"card {harness.card_power()}", file=sys.stderr)
    print(f"portbench: checked {notes['checked']} in {notes['check_s']:.1f} s after the window",
          file=sys.stderr)
    for k, v in result["compared"].items():
        print(f"portbench: compared {k} = {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
