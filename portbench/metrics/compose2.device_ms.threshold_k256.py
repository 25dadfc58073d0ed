"""Device ms of one compose2 graph replay at 512 lanes in the k=256 network:
the kernel time of the compose2 graph launches (the CoFHE nodes' bank
replays and the compute node's combine, all at 512 lanes in this cell),
without the ladder's step graphs (portbench/compose2_graphs.py)."""

from portbench import compose2_graphs

LAYER = "compose2"
MOVES = "threshold_decrypt_cts_per_s"


def read(ctx):
    return compose2_graphs.compose2_ms(ctx.trace) if ctx.trace else None
