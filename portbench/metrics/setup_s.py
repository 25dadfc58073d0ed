"""Set-up seconds: process start to the first timed request (imports, the
program's kernel builds or loads, keys, the pool's encryption, the
warm-up request that captures every graph the traffic uses)."""


def read(ctx):
    return ctx.setup_s
