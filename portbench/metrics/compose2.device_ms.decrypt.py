"""Device ms of one compose2 at 512 lanes (the decrypt's ladder): the
kernel time of the graph launches inside the replays at that batch."""

LAYER = "compose2"
MOVES = "decrypt_p90_s"


def read(ctx):
    return ctx.trace.graph_ms("compose2@512") if ctx.trace else None
