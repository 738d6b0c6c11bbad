"""The busiest held expert's tokens over the mean of the held experts',
over the window, from the program's routing counters (tokens routed to
each held expert, summed over the MoE layers, on the device inside the
step's graph): 1 is an even load; the dropless dispatch serves any."""


def read(ctx):
    tokens = ctx.counts.get("expert_tokens")
    if not tokens or not sum(tokens):
        return None
    return max(tokens) / (sum(tokens) / len(tokens))
