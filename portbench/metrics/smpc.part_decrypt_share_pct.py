"""Share of request wall time inside the CoFHE nodes'
`part_decrypt_tensor` (the union of both nodes' spans)."""

LAYER = "Node runtime / SMPC"
MOVES = "threshold_decrypt_cts_per_s"


def read(ctx):
    return ctx.share("part_decrypt")
