"""Share of request wall time inside `TorchEngine.part_decrypt_batch`, the
wNAF ladder c1^sk (the rest: the inverse, one compose, the host dlog)."""

LAYER = "Engine"
MOVES = "decrypt_p90_s"


def read(ctx):
    return ctx.share("part_decrypt")
