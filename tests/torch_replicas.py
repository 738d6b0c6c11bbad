"""Helpers that the port's sharded-step test files import: a recorder of
every tp replica a sharded layer returns, and of its gradient."""

import torch


def record_block_replicas(monkeypatch, module):
    """Wrap ``module._sharded_block``: every call's output replicas (the
    residual stream after a layer, in the forward and in its recompute) go
    to ``outs``, and in the recompute, where the backward runs, a hook on
    each replica puts its gradient in a list of ``grads``."""
    outs, grads = [], []
    block = module._sharded_block

    def recorded(*args):
        ys = block(*args)
        outs.append([y.detach().clone() for y in ys])
        if torch.is_grad_enabled() and ys[0].requires_grad:
            got = []
            grads.append(got)
            for y in ys:
                y.register_hook(lambda g, got=got: got.append(g.clone()))
        return ys

    monkeypatch.setattr(module, "_sharded_block", recorded)
    return outs, grads


def all_equal(ts):
    return all(torch.equal(ts[0], t) for t in ts[1:])
