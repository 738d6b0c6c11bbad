"""Set-up: seconds from the start of the run's process to its first timed
item (imports, kernel build or load, state made, graph captured, warm-up)."""


def read(ctx):
    return ctx.setup_s
