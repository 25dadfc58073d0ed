"""Share of compose2's roofline at 16384 lanes: the least time of one
compose2's work (portbench/roofline.py, the ladder's recorded trips)
over its measured device time."""

LAYER = "Kernels"
MOVES = "matmul_ops_per_s"


def read(ctx):
    ms = ctx.trace.graph_ms("compose2@16384") if ctx.trace else None
    if not ms:
        return None
    return 100.0 * ctx.roofline.compose2_bound_ms(16384, ctx.widths, "ladder") / ms
