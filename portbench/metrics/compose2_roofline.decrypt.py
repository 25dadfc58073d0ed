"""Share of compose2's roofline at 512 lanes: the least time of one
compose2's work (portbench/roofline.py, decrypt's recorded trips) over
its measured device time."""

LAYER = "Kernels"
MOVES = "decrypt_p90_s"


def read(ctx):
    ms = ctx.trace.graph_ms("compose2@512") if ctx.trace else None
    if not ms:
        return None
    return 100.0 * ctx.roofline.compose2_bound_ms(512, ctx.widths, "decrypt") / ms
