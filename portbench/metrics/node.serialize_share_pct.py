"""Share of request wall time inside `serialize`'s tensor (de)serialization,
on the client, the compute node and the CoFHE nodes (the union)."""

LAYER = "Node runtime / SMPC"
MOVES = "threshold_decrypt_cts_per_s"


def read(ctx):
    return ctx.share("serialize")
