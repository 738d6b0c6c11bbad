"""The window's length over the probe batches completed in it, ms: each
batch with the fetch and the encode of its page."""


def read(ctx):
    return ctx.window.seconds / len(ctx.window.items) * 1e3
