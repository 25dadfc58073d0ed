"""90th percentile of every request's latency in the window."""


def read(ctx):
    return ctx.p90()
