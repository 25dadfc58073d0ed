"""Request wall time outside the matmul's chain, ladder and finalize
(`TorchEngine.last_matmul_phases`): the facade's and the engine's host
work around the job stream."""

LAYER = "Engine"
MOVES = "matmul_ops_per_s"


def read(ctx):
    phases = [c["matmul_phases"] for c in ctx.counters if c["matmul_phases"]]
    if not phases:
        return None
    inside = sum(p["chain_s"] + p["ladder_s"] + p["finalize_s"] for p in phases)
    return 100.0 * (1.0 - inside / sum(ctx.latencies))
