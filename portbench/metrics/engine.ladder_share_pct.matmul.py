"""The matmul's ladder seconds (`TorchEngine.last_matmul_phases`, its
synchronized clock) over request wall time."""

LAYER = "Engine"
MOVES = "matmul_ops_per_s"


def read(ctx):
    phases = [c["matmul_phases"] for c in ctx.counters if c["matmul_phases"]]
    if not phases:
        return None
    return 100.0 * sum(p["ladder_s"] for p in phases) / sum(ctx.latencies)
