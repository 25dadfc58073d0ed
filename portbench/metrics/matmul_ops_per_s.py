"""ct-scalar products (n m p a request) of every completed request over the
whole window."""


def read(ctx):
    return ctx.rate()
