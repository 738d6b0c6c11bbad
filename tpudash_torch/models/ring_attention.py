"""Ring attention over an ``sp`` ring: the counterpart of
``tpudash/models/ring_attention.py``, driven from one process over a
``parallel.mesh.Mesh`` of (dp, sp) devices.

Each device holds a contiguous (B/dp, T/sp) block of q, k and v.  The K/V
blocks rotate one hop a step around their dp row's sp ring (a copy to the
next device, which autograd sees, so the backward pass sends gradients the
other way), and the softmax is streamed as in the reference: a running
max, denominator and accumulator in f32, with the finite −1e30 standing in
for −inf so that ``exp`` stays defined before the first unmasked key.  The
causal mask works by global position: the block that device s holds at
step i came from device (s − i) mod sp.  As in the reference, causally
dead blocks are computed and masked, not skipped.

``make_ring_train_step`` trains the demo transformer with this attention:
parameters replicated on every device, the batch split over dp and the
sequence over sp, each layer recomputed in backward.  The reference
computes all of it in plain XLA, so there is no hand kernel here either.
"""

from __future__ import annotations

import functools

import torch

from tpudash_torch.models import workload as w
from tpudash_torch.models.graphed import compiled
from tpudash_torch.parallel.mesh import Mesh

_NEG_BIG = -1e30


def _ring_row(qs: list, ks: list, vs: list, causal: bool) -> list:
    """One dp row's ring: ``qs[s]``, ``ks[s]``, ``vs[s]`` are the (B, Tl, H,
    hd) blocks on device s of the row → the attention output of each
    device's queries, (B, Tl, H, hd) in q's dtype, on its device."""
    sp = len(qs)
    devs = [q.device for q in qs]
    B, T, H, hd = qs[0].shape
    qh = [q.transpose(1, 2).float() * hd**-0.5 for q in qs]
    m = [torch.full((B, H, T), _NEG_BIG, device=d) for d in devs]  # running max
    l = [torch.zeros((B, H, T), device=d) for d in devs]  # running denominator
    acc = [torch.zeros((B, H, T, hd), device=d) for d in devs]  # running numerator
    k_blk, v_blk = list(ks), list(vs)
    for i in range(sp):
        for s, dev in enumerate(devs):
            scores = torch.matmul(qh[s], k_blk[s].transpose(1, 2).float().transpose(-1, -2))
            if causal:
                src = (s - i) % sp  # the device this K/V block started on
                q_pos = s * T + torch.arange(T, device=dev)[:, None]
                k_pos = src * T + torch.arange(T, device=dev)[None, :]
                scores = scores.masked_fill(k_pos > q_pos, _NEG_BIG)
            m_new = torch.maximum(m[s], scores.amax(-1))
            p = torch.exp(scores - m_new[..., None])
            corr = torch.exp(m[s] - m_new)
            l[s] = l[s] * corr + p.sum(-1)
            acc[s] = acc[s] * corr[..., None] + torch.matmul(p, v_blk[s].transpose(1, 2).float())
            m[s] = m_new
        if i + 1 < sp:  # rotate K/V one hop: device s's block moves to s + 1
            k_blk = [k_blk[(s - 1) % sp].to(dev) for s, dev in enumerate(devs)]
            v_blk = [v_blk[(s - 1) % sp].to(dev) for s, dev in enumerate(devs)]
    return [(a / d[..., None]).transpose(1, 2).to(q.dtype) for a, d, q in zip(acc, l, qs)]


def _ring_axes(mesh: Mesh, dp_axis: str, sp_axis: str) -> tuple[int, int]:
    if mesh.axis_names != (dp_axis, sp_axis):
        raise ValueError(f"ring attention needs a ({dp_axis}, {sp_axis}) mesh, "
                         f"not {mesh.axis_names}")
    return mesh.shape[dp_axis], mesh.shape[sp_axis]


def _blocks(x: torch.Tensor, mesh: Mesh, dp: int, sp: int) -> list:
    """x's (B/dp, T/sp) blocks, block (r, s) on mesh device r·sp + s."""
    B, T = x.shape[:2]
    for what, size, axis, n in (("batch", B, "dp", dp), ("sequence", T, "sp", sp)):
        if size % n:
            raise ValueError(f"{what} {size} does not split over the {axis} axis of size {n}")
    return [blk.to(mesh.devices[r * sp + s])
            for r, rows in enumerate(x.chunk(dp, 0)) for s, blk in enumerate(rows.chunk(sp, 1))]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh, *,
                   dp_axis: str = "dp", sp_axis: str = "sp", causal: bool = True) -> torch.Tensor:
    """Ring attention over q, k, v of shape (B, T, H, hd): B split over
    ``dp_axis``, T over ``sp_axis``, heads local.  Returns the (B, T, H, hd)
    output on q's device."""
    dp, sp = _ring_axes(mesh, dp_axis, sp_axis)
    qs, ks, vs = (_blocks(x, mesh, dp, sp) for x in (q, k, v))
    rows = []
    for r in range(dp):
        row = slice(r * sp, (r + 1) * sp)
        outs = _ring_row(qs[row], ks[row], vs[row], causal)
        rows.append(torch.cat([o.to(q.device) for o in outs], 1))
    return torch.cat(rows, 0)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Unsharded softmax attention in f32: the correctness oracle."""
    B, T, H, hd = q.shape
    qh, kh, vh = (x.transpose(1, 2).float() for x in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * hd**-0.5
    if causal:
        mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, _NEG_BIG)
    out = torch.matmul(torch.softmax(s, dim=-1), vh)
    return out.transpose(1, 2).to(q.dtype)


# --- long-context demo workload: sequence-parallel transformer ------------------

_LAYER = ("ln1", "wqkv", "wo", "ln2", "w_up", "w_down")


def _ring_block(cfg: w.WorkloadConfig, dp: int, sp: int, *tensors) -> tuple:
    """One layer over every device of the mesh: ``tensors`` are each
    device's (B/dp, T/sp, d) block, then each device's replica of the
    layer's weights in ``_LAYER`` order."""
    n = dp * sp
    hs = tensors[:n]
    layers = [dict(zip(_LAYER, tensors[n + j * len(_LAYER):n + (j + 1) * len(_LAYER)]))
              for j in range(n)]
    H, hd = cfg.n_heads, cfg.head_dim
    q, k, v = [], [], []
    for h, p in zip(hs, layers):
        B, T, d = h.shape
        qkv = torch.matmul(w._rmsnorm(h, p["ln1"]), p["wqkv"])
        for out, t in zip((q, k, v), qkv.split(d, dim=-1)):
            out.append(t.reshape(B, T, H, hd))
    outs = []
    for r in range(dp):
        row = slice(r * sp, (r + 1) * sp)
        outs += _ring_row(q[row], k[row], v[row], causal=True)
    new = []
    for h, o, p in zip(hs, outs, layers):
        h = h + torch.matmul(o.reshape(h.shape), p["wo"])
        new.append(h + w._mlp(w._rmsnorm(h, p["ln2"]), p["w_up"], p["w_down"]))
    return tuple(new)


def ring_loss_fn(replicas: tuple, tokens: torch.Tensor, cfg: w.WorkloadConfig,
                 mesh: Mesh) -> torch.Tensor:
    """Next-token cross-entropy of the ring forward, on the mesh's first
    device.  As in the reference, the forward runs on the FULL sequence
    (T must split over sp) and the last position's logits are dropped; the
    workload's ``loss_fn`` drops the last input token instead, which would
    leave T − 1 positions to split.  The mean is over B·(T − 1) positions."""
    dp, sp = _ring_axes(mesh, "dp", "sp")
    B, T = tokens.shape
    tok = _blocks(tokens, mesh, dp, sp)
    hs = tuple(rep["embed"][t] for rep, t in zip(replicas, tok))
    block = functools.partial(_ring_block, cfg, dp, sp)
    for layer in range(cfg.n_layers):
        weights = [rep["blocks"][n][layer] for rep in replicas for n in _LAYER]
        hs = w.checkpoint_across_devices(block, *hs, *weights)
    dev0, Tl = mesh.devices[0], T // sp
    nll = []
    for j, (h, rep) in enumerate(zip(hs, replicas)):
        r, s = divmod(j, sp)
        rows = tokens[r * (B // dp):(r + 1) * (B // dp)].to(h.device)
        targets = rows[:, s * Tl + 1:(s + 1) * Tl + 1]  # one short on the last block
        logits = torch.matmul(w._rmsnorm(h, rep["ln_f"]).float(), rep["unembed"].float())
        logp = torch.log_softmax(logits[:, :targets.shape[1]], dim=-1)
        nll.append(-logp.gather(-1, targets[..., None]).sum().to(dev0))
    return torch.stack(nll).sum() / (B * (T - 1))


def make_ring_train_step(mesh: Mesh, cfg: w.WorkloadConfig):
    """The train step with ring attention over a (dp, sp) mesh, driven from
    one process: parameters replicated on every device, the batch split over
    dp and the sequence over sp.  The loss is the mean over the whole batch,
    so each replica's gradient is its blocks' share; the gradients are
    summed over the mesh (the reference's sum over sp and mean over dp), and
    every replica runs the same AdamW update, staying bitwise equal.

    Returns ``(step, shard_inputs)`` as ``make_sharded_train_step`` does:
    ``shard_inputs(params, optimizer)`` gives ``(replicas, optimizer)``, a
    tuple of one parameter tree per mesh device and an AdamW over all of
    them; ``step(replicas, optimizer, tokens)`` updates them in place and
    returns the loss before the update on the mesh's first device.  The
    step is ``graphed.compiled``, as the reference jits it: on GPUs one
    CUDA graph over the mesh, each K/V hop a node of it; on the CPU eager.
    """
    dp, sp = _ring_axes(mesh, "dp", "sp")
    for what, size, axis, n in (("batch", cfg.batch, "dp", dp), ("seq", cfg.seq, "sp", sp)):
        if size % n:
            raise ValueError(f"{what} {size} does not split over the {axis} axis of size {n}")

    def shard_inputs(params: dict, optimizer: "torch.optim.Optimizer | None"):
        replicas = tuple(
            w._unflatten((name, t.detach().to(dev, copy=True).requires_grad_(True))
                         for name, t in w.named_leaves(params))
            for dev in mesh.devices)
        tensors = [t for rep in replicas for t in w.leaves(rep)]
        opt = w._adamw(tensors, cfg)
        if optimizer is not None and optimizer.state:
            full = optimizer.state_dict()
            n = len(w.leaves(params))
            # every replica's state a set of tensors of its own: the
            # optimizer updates them in place
            w.load_optimizer_state(opt, {
                "state": {j * n + i: {k: v.clone() if k == "step" else v.to(dev, copy=True)
                                      for k, v in st.items()}
                          for j, dev in enumerate(mesh.devices)
                          for i, st in full["state"].items()},
                "param_groups": [{**g, "params": list(range(len(tensors)))}
                                 for g in full["param_groups"]]})
        return replicas, opt

    def step(replicas: tuple, optimizer: torch.optim.Optimizer, tokens: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = ring_loss_fn(replicas, tokens, cfg, mesh)
        loss.backward()
        for same in zip(*(w.leaves(rep) for rep in replicas)):
            w.sum_replica_grads(list(same))
        optimizer.step()
        return loss.detach()

    return compiled(step), shard_inputs
