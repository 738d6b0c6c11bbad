"""Device time of the peer-to-peer copies (``Memcpy PtoP``) a train step,
ms, summed over the GPUs: the group collectives' traffic between GPUs."""


def read(ctx):
    if ctx.trace is None or not ctx.counts.get("steps"):
        return None
    seconds = ctx.trace.seconds(r"Memcpy PtoP")
    if not seconds:  # no copy between distinct GPUs (one card named several times)
        return None
    return seconds / ctx.counts["steps"] * 1e3
