"""Share of compose2's roofline at 512 lanes and k=256: the least time of
one compose2's work at the configuration's widths and the trips recorded
at k=256 (portbench/roofline_k256.py) over its measured device time
(compose2.device_ms.threshold_k256)."""

from portbench import compose2_graphs, roofline_k256

LAYER = "Kernels"
MOVES = "threshold_decrypt_cts_per_s"


def read(ctx):
    ms = compose2_graphs.compose2_ms(ctx.trace) if ctx.trace else None
    if not ms:
        return None
    return 100.0 * roofline_k256.compose2_bound_ms(512, ctx.widths) / ms
