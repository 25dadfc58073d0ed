"""Ciphertexts decrypted through the network by every completed request
over the whole window."""


def read(ctx):
    return ctx.rate()
