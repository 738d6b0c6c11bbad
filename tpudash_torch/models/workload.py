"""Decoder-only transformer demo workload: the counterpart of
``tpudash/models/workload.py`` on one device.

The parameter tree has the reference's names and stacked layout (leading
dim ``n_layers`` on ``blocks.*``, bf16 weights, f32 norms), and the forward
keeps every dtype point of the reference:

- RMSNorm in f32 (eps 1e-6), cast to bf16, on GPUs by a hand-written
  kernel forward and backward (``ops/csrc/rmsnorm.cu``);
- the qkv, out, up and down products in bf16;
- attention scores in f32 (bf16 operands, whose products are exact in f32),
  times ``hd**-0.5``, a causal mask filled with −1e30, softmax in f32, then
  probabilities cast to bf16;
- ``gelu(approximate="tanh")``, the form ``jax.nn.gelu`` defaults to;
- the unembed product to f32 logits, and ``log_softmax`` cross-entropy on
  the shifted tokens.

Attention is written as the reference writes it, two products around a
masked softmax: a fused attention call would move the rounding points.
Each layer is recomputed in the backward pass (``torch.utils.checkpoint``,
as ``jax.checkpoint`` does in the reference), which keeps activation memory
to about one layer's.

The dp×tp sharded step (``make_sharded_train_step``) runs over a
``parallel.mesh.Mesh`` from one process, as the reference's ``jax.jit``
over a local mesh does, and returns it compiled as that ``jax.jit`` is:
on GPUs one CUDA graph over the mesh (``models/graphed.py``).  A sharded
leaf is a tuple over the dp rows of a tuple over the tp columns of
per-device tensors (:class:`ShardPlan`).  The step is the reference's SPMD
program: every device of a row holds the residual stream and the norms,
and the tp psums and the dp gradient all-reduce are group collectives
(``parallel/collectives.py``) that autograd sees.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tpudash_torch.models.graphed import compiled
from tpudash_torch.ops import kernels
from tpudash_torch.parallel.collectives import (
    allreduce_replicas,
    copy_to_group,
    gather_from_group,
    one_of_replicas,
    psum_group,
    reduce_from_group,
    scatter_to_group,
    vocab_parallel_nll,
)
from tpudash_torch.parallel.mesh import Mesh


@dataclass(frozen=True)
class WorkloadConfig:
    vocab: int = 512
    d_model: int = 256
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 1024
    seq: int = 128
    batch: int = 8
    lr: float = 3e-4

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads


# --- parameters -------------------------------------------------------------

def init_params(cfg: WorkloadConfig, generator: torch.Generator) -> dict:
    """Stacked-layer parameter tree (leading dim = n_layers on block
    leaves) at the reference's scales, drawn from ``generator`` on its
    device.  The numbers differ from the reference's ``PRNGKey`` draws;
    :func:`params_from_numpy` carries the reference's own across."""
    dev = generator.device
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers

    def norm(shape, scale):
        x = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return (x * scale).to(torch.bfloat16)

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    return {
        "embed": norm((cfg.vocab, d), 0.02),
        "blocks": {
            "ln1": ones((L, d)),
            "wqkv": norm((L, d, 3 * d), d**-0.5),
            "wo": norm((L, d, d), d**-0.5),
            "ln2": ones((L, d)),
            "w_up": norm((L, d, f), d**-0.5),
            "w_down": norm((L, f, d), f**-0.5),
        },
        "ln_f": ones((d,)),
        "unembed": norm((d, cfg.vocab), d**-0.5),
    }


def params_from_numpy(tree, device) -> dict:
    """A parameter tree of host arrays (the reference's, through
    ``jax.device_get``; bfloat16 arrays included) as tensors on ``device``,
    bf16 leaves as bf16 and every other leaf as f32, each value exact."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    dtype = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
    return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dtype)


def named_leaves(tree: dict, prefix: str = "") -> list:
    """(dotted name, leaf) pairs of a tree in a fixed order: sorted keys,
    depth first."""
    out = []
    for k in sorted(tree):
        v, name = tree[k], f"{prefix}{k}"
        out += named_leaves(v, name + ".") if isinstance(v, dict) else [(name, v)]
    return out


def leaves(params: dict) -> list[torch.Tensor]:
    """The tree's tensors in a fixed order (the optimizer's parameter list)."""
    return [v for _, v in named_leaves(params)]


def _unflatten(pairs) -> dict:
    tree: dict = {}
    for name, v in pairs:
        *path, last = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


# --- forward ----------------------------------------------------------------

def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = kernels.NORM_EPS) -> torch.Tensor:
    """RMSNorm over the last dim in f32, rounded once to bf16: on a GPU the
    hand-written kernels, forward and backward (``kernels.rmsnorm``; x
    contiguous bf16, d a multiple of 8), on the CPU their plain version."""
    if x.is_cuda:
        return kernels.rmsnorm(x, scale, eps)
    return kernels.rmsnorm_ref(x, scale, eps)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal scaled-dot-product attention on head-major (B, H, T, hd) bf16
    tensors."""
    T, hd = q.shape[2], q.shape[3]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (hd**-0.5)
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, -1e30)
    probs = torch.softmax(scores, dim=-1).to(torch.bfloat16)
    return torch.matmul(probs, v)


def _heads(qkv: torch.Tensor, hd: int) -> torch.Tensor:
    """Attention over the heads of ``qkv`` (B, T, 3·w), whose thirds hold
    the q, k and v columns of w / hd whole heads → (B, T, w)."""
    B, T, w3 = qkv.shape
    w = w3 // 3
    q, k, v = (t.reshape(B, T, w // hd, hd).transpose(1, 2) for t in qkv.split(w, dim=-1))
    return _sdpa(q, k, v).transpose(1, 2).reshape(B, T, w)


def _attention(x: torch.Tensor, wqkv: torch.Tensor, wo: torch.Tensor, cfg: WorkloadConfig) -> torch.Tensor:
    return torch.matmul(_heads(torch.matmul(x, wqkv), cfg.head_dim), wo)


def _mlp(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    h = F.gelu(torch.matmul(x, w_up), approximate="tanh")
    return torch.matmul(h, w_down)


def _block(h, ln1, wqkv, wo, ln2, w_up, w_down, cfg):
    h = h + _attention(_rmsnorm(h, ln1), wqkv, wo, cfg)
    return h + _mlp(_rmsnorm(h, ln2), w_up, w_down)


def forward(params: dict, tokens: torch.Tensor, cfg: WorkloadConfig) -> torch.Tensor:
    """tokens (B, T) int64 → logits (B, T, vocab) f32."""
    x = params["embed"][tokens].to(torch.bfloat16)
    b = params["blocks"]
    names = ("ln1", "wqkv", "wo", "ln2", "w_up", "w_down")
    for layer in range(cfg.n_layers):
        # recompute the layer in backward rather than keep its T×T
        # attention probabilities: O(one layer) activation memory
        # (nothing in the model draws random numbers, so no RNG state to
        # stash: a stash reads every device's generator, which a CUDA graph's
        # capture refuses)
        x = checkpoint(_block, x, *(b[n][layer] for n in names), cfg, use_reentrant=False,
                       preserve_rng_state=False)
    x = _rmsnorm(x, params["ln_f"])
    return torch.matmul(x.float(), params["unembed"].float())


def loss_fn(params: dict, tokens: torch.Tensor, cfg: WorkloadConfig) -> torch.Tensor:
    """Next-token cross-entropy (shift-by-one inside the batch)."""
    logits = forward(params, tokens[:, :-1], cfg)
    targets = tokens[:, 1:]
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None]).squeeze(-1).mean()


# --- training ---------------------------------------------------------------

def _adamw(tensors: list, cfg: WorkloadConfig) -> torch.optim.AdamW:
    """AdamW over ``tensors``; on GPUs ``capturable``, its step counts and
    bias corrections on the devices, so that a CUDA graph of the step
    (``models/graphed.py``) advances them.  The CPU's AdamW refuses
    ``capturable``."""
    return torch.optim.AdamW(tensors, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01,
                             capturable=tensors[0].device.type == "cuda")


def load_optimizer_state(optimizer: torch.optim.Optimizer, state: dict) -> None:
    """``optimizer.load_state_dict(state)``, keeping the optimizer's own
    ``capturable``: a state saved by a non-capturable AdamW (a checkpoint of
    the port before its step became a CUDA graph, or one saved on the CPU)
    restores into a capturable one with its step counts moved to each
    parameter's device, and the other way round."""
    groups = [{**saved, "capturable": live["capturable"]}
              for saved, live in zip(state["param_groups"], optimizer.param_groups, strict=True)]
    optimizer.load_state_dict({**state, "param_groups": groups})


def make_optimizer(params: dict, cfg: WorkloadConfig) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=0.01)``: AdamW over EVERY parameter,
    norms and embeddings included (optax masks nothing), with moments in
    the parameters' own dtype (bf16 for the weights), as optax keeps them."""
    return _adamw(leaves(params), cfg)


def make_train_state(cfg: WorkloadConfig, generator: torch.Generator):
    """(params, optimizer); the parameters require grad."""
    params = init_params(cfg, generator)
    for p in leaves(params):
        p.requires_grad_(True)
    return params, make_optimizer(params, cfg)


def train_step(params: dict, optimizer: torch.optim.Optimizer, tokens: torch.Tensor,
               cfg: WorkloadConfig) -> torch.Tensor:
    """One step; updates ``params`` IN PLACE (the reference returns new
    arrays) and returns the loss before the update as a 0-d tensor on the
    device, unread, so that steps dispatch back to back."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(params, tokens, cfg)
    loss.backward()
    optimizer.step()
    return loss.detach()


# --- dp×tp sharding -----------------------------------------------------------

#: the dim of each leaf that splits over tp, None for a replicated leaf, as
#: ``tpudash/models/workload.py::param_shardings`` gives it (Megatron-style:
#: qkv and up column-parallel, o and down row-parallel, the embedding on the
#: model dim, the unembed on the vocabulary, norms replicated; the
#: layer-stack dim never split)
TP_DIMS = {
    "embed": 1,
    "blocks.ln1": None,
    "blocks.wqkv": 2,
    "blocks.wo": 1,
    "blocks.ln2": None,
    "blocks.w_up": 2,
    "blocks.w_down": 1,
    "ln_f": None,
    "unembed": 1,
}


@dataclass(frozen=True)
class ShardPlan:
    """Where each parameter of ``cfg`` lives on a (dp, tp) mesh.

    Row r of the mesh is one data-parallel replica.  Column c holds shard c
    of each tp-split leaf and a replica of each norm, as the reference's
    ``ns(None, None)`` replicates them, and runs the layers on its replica
    of the residual stream; the row's loss lies on its first device.
    ``wqkv`` splits by heads when the heads divide over tp: shard c holds
    the q, k and v columns of heads c·H/tp to (c+1)·H/tp − 1, so that
    attention runs where the shard lies.  When they do not, it splits in
    contiguous column blocks, as the reference's ``P(None, None, "tp")``
    lays it out, and every column gathers qkv and attends over every head.
    Either way a shard has the reference's shard shape.
    """

    mesh: Mesh
    cfg: WorkloadConfig

    @property
    def dp(self) -> int:
        return self.mesh.shape["dp"]

    @property
    def tp(self) -> int:
        return self.mesh.shape["tp"]

    @property
    def heads_aligned(self) -> bool:
        return self.cfg.n_heads % self.tp == 0

    def device(self, row: int, col: int = 0) -> torch.device:
        return self.mesh.devices[row * self.tp + col]

    def split(self, name: str, full: torch.Tensor) -> list:
        """The shards of the full leaf ``name`` on its device (views where
        a slice will do), tp of them; for a replicated leaf, the leaf itself
        tp times."""
        dim = TP_DIMS[name]
        if dim is None:
            return [full] * self.tp
        if name == "blocks.wqkv" and self.heads_aligned:
            d = self.cfg.d_model
            w = d // self.tp
            return [torch.cat([full.narrow(dim, j * d + c * w, w) for j in range(3)], dim)
                    for c in range(self.tp)]
        return list(full.chunk(self.tp, dim))

    def join(self, name: str, parts: list) -> torch.Tensor:
        """The inverse of :meth:`split`: a new full leaf on the first
        shard's device."""
        dim = TP_DIMS[name]
        if dim is None:  # column 0's replica
            return parts[0].clone()
        parts = [p.to(parts[0].device) for p in parts]
        if name == "blocks.wqkv" and self.heads_aligned:
            w = self.cfg.d_model // self.tp
            return torch.cat([p.narrow(dim, j * w, w) for j in range(3) for p in parts], dim)
        return torch.cat(parts, dim)

    def part_device(self, name: str, row: int, i: int) -> torch.device:
        """The device of shard ``i`` of leaf ``name`` in dp row ``row``."""
        return self.device(row, i)

    def replicas(self, sharded: dict) -> list:
        """The groups of tensors that hold one value: each shard over the dp
        rows."""
        return row_replicas(sharded)


def shard_plan(mesh: Mesh, cfg: WorkloadConfig) -> ShardPlan:
    """The plan of ``cfg`` on a (dp, tp) mesh.  A dimension that does not
    split evenly over its axis raises ValueError, as the reference's
    ``device_put`` refuses it; nothing is resized."""
    if mesh.axis_names != ("dp", "tp"):
        raise ValueError(f"the sharded step needs a (dp, tp) mesh, not {mesh.axis_names}")
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    for what, size, axis, n in (("batch", cfg.batch, "dp", dp), ("d_model", cfg.d_model, "tp", tp),
                                ("d_ff", cfg.d_ff, "tp", tp), ("vocab", cfg.vocab, "tp", tp)):
        if size % n:
            raise ValueError(f"{what} {size} does not split over the {axis} axis of size {n}")
    return ShardPlan(mesh, cfg)


def shard_params(tree: dict, plan: ShardPlan) -> dict:
    """The full tree's shards, each a tensor of its own on the device the
    plan names: every leaf becomes a tuple over the dp rows of a tuple over
    the parts ``plan.split`` gives (for a :class:`ShardPlan`, tp of them,
    a norm's replicas included)."""
    out = []
    for name, full in named_leaves(tree):
        parts = plan.split(name, full.detach())
        out.append((name, tuple(
            tuple(p.to(plan.part_device(name, r, c), copy=True).contiguous()
                  for c, p in enumerate(parts))
            for r in range(plan.dp))))
    return _unflatten(out)


def gather_params(sharded: dict, plan: ShardPlan) -> dict:
    """The full tree from row 0's shards, as new tensors on row 0's first
    device (a replicated leaf from column 0)."""
    return _unflatten((name, plan.join(name, [p.detach() for p in rows[0]]))
                      for name, rows in named_leaves(sharded))


def shard_leaves(sharded: dict) -> list[torch.Tensor]:
    """Every shard of a sharded tree, in leaf order, then row, then column
    (the sharded optimizer's parameter list)."""
    return [p for _, rows in named_leaves(sharded) for row in rows for p in row]


def shard_optimizer_state(state: dict, sharded: dict, plan: ShardPlan) -> dict:
    """``state_dict()`` of an optimizer over the full tree as that of one
    over ``shard_leaves(sharded)``: each moment split as its parameter is,
    every shard's state a set of tensors of its own on its device (the
    optimizer updates them in place)."""
    out, j = {}, 0
    for i, (name, rows) in enumerate(named_leaves(sharded)):
        st = state["state"].get(i)
        parts = None if st is None else {
            k: plan.split(name, st[k]) for k in ("exp_avg", "exp_avg_sq")}
        for r in range(plan.dp):
            for c in range(len(rows[0])):
                if st is not None:
                    dev = plan.part_device(name, r, c)
                    out[j] = {"step": st["step"].clone(), **{
                        k: v[c].to(dev, copy=True).contiguous() for k, v in parts.items()}}
                j += 1
    groups = [{**g, "params": list(range(j))} for g in state["param_groups"]]
    return {"state": out, "param_groups": groups}


def gather_optimizer_state(optimizer: torch.optim.Optimizer, sharded: dict,
                           plan: ShardPlan) -> dict:
    """The inverse of :func:`shard_optimizer_state`: the ``state_dict()``
    an optimizer over the full tree would have, from row 0's shards."""
    sd = optimizer.state_dict()
    out, j, names = {}, 0, named_leaves(sharded)
    for i, (name, rows) in enumerate(names):
        k = len(rows[0])
        sts = [sd["state"].get(x) for x in range(j, j + k)]
        j += k * plan.dp
        if sts[0] is not None:
            out[i] = {"step": sts[0]["step"], **{
                m: plan.join(name, [s[m] for s in sts]) for m in ("exp_avg", "exp_avg_sq")}}
    groups = [{**g, "params": list(range(len(names)))} for g in sd["param_groups"]]
    return {"state": out, "param_groups": groups}


def gather_train_state(sharded: dict, optimizer: torch.optim.Optimizer, plan: ShardPlan):
    """The inverse of ``shard_inputs``: the full tree on row 0's first
    device and an AdamW over it holding the moments an unsharded optimizer
    would.  A checkpoint saves this, so that it is the same whatever the
    mesh."""
    params = gather_params(sharded, plan)
    for p in leaves(params):
        p.requires_grad_(True)
    opt = make_optimizer(params, plan.cfg)
    load_optimizer_state(opt, gather_optimizer_state(optimizer, sharded, plan))
    return params, opt


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The 2-D product of bf16 operands with an f32 result: exact products,
    f32 sums (the tensor cores' bf16 product with an f32 output on the GPU,
    the same in f32 arithmetic on the CPU, which has no such product)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


class _RowParallel(torch.autograd.Function):
    """A row-parallel shard's partial product ``x @ w`` of bf16 operands,
    kept in f32 so that the partials add up to what the unsharded bf16
    product rounds once (a partial rounded to bf16 would round twice).  Its
    gradient arrives from that one rounding, so it is exact in bf16, and
    the backward is the bf16 product's."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(_flat(x), w).reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(torch.bfloat16)
        return torch.matmul(g, w.t()), torch.matmul(_flat(x).t(), _flat(g))


class _ColumnParallel(torch.autograd.Function):
    """Each column's replica ``xs[c]`` (bf16) times its column shard
    ``ws[c]``, both on the column's device: the unsharded bf16 product, one
    column block per device.  Megatron's "f" sits at its input: the
    backward gives every replica the psum of the columns' f32 partial
    gradients, in column order and rounded once, as the unsharded
    product's one backward product rounds (autograd would add them
    rounded, in bf16)."""

    @staticmethod
    def forward(ctx, *args):
        n = len(args) // 2
        xs, ws = args[:n], args[n:]
        ctx.save_for_backward(*xs, *ws)
        return tuple(torch.matmul(xc, w) for xc, w in zip(xs, ws))

    @staticmethod
    def backward(ctx, *gs):
        saved = ctx.saved_tensors  # unpack once: checkpoint allows no more
        xs, ws = saved[:len(gs)], saved[len(gs):]
        parts = [_mm_f32(_flat(g), w.t()) for w, g in zip(ws, gs)]
        gxs = [g.reshape(xs[0].shape) for g in psum_group(parts, torch.bfloat16)]
        gws = [torch.matmul(_flat(xc).t(), _flat(g)) for xc, g in zip(xs, gs)]
        return (*gxs, *gws)


def checkpoint_across_devices(fn, *tensors):
    """``checkpoint(fn, *tensors)`` for a function that runs on several
    devices, in the reentrant form.  Autograd runs a backward on one thread
    per device, and the non-reentrant form then recomputes ``fn`` from
    several of them at once, which it does not support ("early_stop is
    set"); the reentrant form recomputes once, in the thread of its one
    backward node.  It tracks the gradients of top-level tensor arguments
    only, so ``fn`` takes every tensor flat.  With nothing to
    differentiate it calls ``fn``: there is nothing to recompute.  No RNG
    state is stashed for the recompute: nothing in the models draws random
    numbers, and a CUDA graph's capture refuses the stash."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)):
        return fn(*tensors)
    return checkpoint(fn, *tensors, use_reentrant=True, preserve_rng_state=False)


#: a column's tensors of one layer, in the order :func:`_sharded_block`
#: takes them
COLUMN = ("h", "ln1", "ln2", "wqkv", "wo", "w_up", "w_down")


def _sharded_block(cfg, aligned, *tensors):
    """One layer over a tp group, as the reference's SPMD program runs it:
    column c's replica of the residual stream, its replicas of the norms
    and its wqkv, wo, w_up and w_down shards are ``tensors[7c:7c + 7]``
    (:data:`COLUMN` order), all on its device.  Each column normalises its
    own replica; each row-parallel product's f32 partials are psummed over
    the group in column order and rounded once.  Returns every column's
    replica of the layer's output, all of them the same bits."""
    hs, ln1, ln2, wqkv, wo, w_up, w_down = (tensors[i::len(COLUMN)] for i in range(len(COLUMN)))
    qkv = _ColumnParallel.apply(*(_rmsnorm(h, s) for h, s in zip(hs, ln1)), *wqkv)
    if aligned:  # each column attends over its own heads
        outs = [_heads(t, cfg.head_dim) for t in qkv]
    else:  # every column attends over every head and keeps its own columns
        outs = scatter_to_group([_heads(t, cfg.head_dim) for t in gather_from_group(qkv, -1)], -1)
    attn = reduce_from_group([_RowParallel.apply(o, w) for o, w in zip(outs, wo)], torch.bfloat16)
    hs = [h + a for h, a in zip(hs, attn)]
    ups = _ColumnParallel.apply(*(_rmsnorm(h, s) for h, s in zip(hs, ln2)), *w_up)
    mlp = reduce_from_group([_RowParallel.apply(F.gelu(u, approximate="tanh"), w)
                             for u, w in zip(ups, w_down)], torch.bfloat16)
    return tuple(h + m for h, m in zip(hs, mlp))


def _row_logits(sharded: dict, tokens: torch.Tensor, plan: ShardPlan, row: int) -> tuple:
    """The forward of dp row ``row`` on its tokens → each column's
    vocab-parallel f32 logits on its own device.  The embedding's column
    shards are all-gathered, so that every column holds the residual
    stream."""
    xs = gather_from_group([e[tokens.to(e.device)] for e in sharded["embed"][row]], -1)
    b = sharded["blocks"]
    block = functools.partial(_sharded_block, plan.cfg, plan.heads_aligned)
    for layer in range(plan.cfg.n_layers):
        xs = checkpoint_across_devices(block, *(
            t for c, x in enumerate(xs) for t in (x, *(b[n][row][c][layer] for n in COLUMN[1:]))))
    # cast each replica to f32 before "f", so that the columns' gradients
    # add up in f32 and round once
    xs = copy_to_group([_rmsnorm(x, s).float() for x, s in zip(xs, sharded["ln_f"][row])])
    return tuple(torch.matmul(x, u.float()) for x, u in zip(xs, sharded["unembed"][row]))


def sharded_loss_fn(sharded: dict, tokens: torch.Tensor, plan: ShardPlan) -> torch.Tensor:
    """:func:`loss_fn` over the mesh: the batch splits over the dp rows;
    each row's loss is its columns' vocab-parallel cross-entropy
    (:func:`vocab_parallel_nll`), taken from its first column; the loss, on
    the mesh's first device, is the mean of the rows' means (equal shares,
    so the reference's mean over the whole batch)."""
    if tokens.shape[0] % plan.dp:
        raise ValueError(f"batch {tokens.shape[0]} does not split over the dp axis of size {plan.dp}")
    dev0 = plan.device(0)
    losses = []
    for r, rows in enumerate(tokens.chunk(plan.dp, 0)):
        rows = rows.to(plan.device(r))
        nll = vocab_parallel_nll(_row_logits(sharded, rows[:, :-1], plan, r), rows[:, 1:])
        losses.append(one_of_replicas([x.mean() for x in nll]).to(dev0))
    return torch.stack(losses).mean()


def sum_replica_grads(replicas: list) -> None:
    """Give every replica of one tensor the sum of their gradients, an
    all-reduce over the group (:func:`allreduce_replicas`: added in f32 in
    replica order, rounded once to the parameter's dtype), so the replicas
    stay bitwise equal through the optimizer's step."""
    if len(replicas) == 1:
        return
    for p, g in zip(replicas, allreduce_replicas([p.grad for p in replicas])):
        p.grad = g


def row_replicas(sharded: dict) -> list:
    """Each shard of each leaf of a sharded tree over its dp rows: the
    groups whose gradients :func:`sum_replica_grads` adds."""
    return [[row[c] for row in rows] for _, rows in named_leaves(sharded) for c in range(len(rows[0]))]


def plan_train_step(plan, loss_fn):
    """The train step over the shards a plan lays out, driven from one
    process: ``plan`` gives ``cfg``, ``dp``, ``split``/``join``/``part_device``
    for each leaf and ``replicas`` (a :class:`ShardPlan`, or the pipeline's
    and the MoE's plans), and ``loss_fn(sharded, tokens)`` the loss on one
    device.  After backward the gradients of each group of replicas are
    summed (the loss is already the mean over them, so this is the
    reference's all-reduce of the mean), and every replica runs the same
    AdamW update: the replicas stay bitwise equal.

    Returns ``(step, shard_inputs)``.  ``shard_inputs(params, optimizer)``
    turns a full train state (its optimizer may hold restored moments, or
    be None) into ``(sharded, sharded_optimizer)``;
    ``step(sharded, sharded_optimizer, tokens)`` updates them in place and
    returns the loss before the update, a 0-d tensor, unread.  The tokens
    may lie on any device: the loss places each part of the batch.  The
    step is ``graphed.compiled``: on GPUs one CUDA graph over every device
    of the plan, captured at its first call; on the CPU eager.
    """

    def shard_inputs(params: dict, optimizer: "torch.optim.Optimizer | None"):
        sharded = shard_params(params, plan)
        tensors = shard_leaves(sharded)
        for t in tensors:
            t.requires_grad_(True)
        opt = _adamw(tensors, plan.cfg)
        if optimizer is not None and optimizer.state:
            load_optimizer_state(opt, shard_optimizer_state(optimizer.state_dict(), sharded, plan))
        return sharded, opt

    def step(sharded: dict, optimizer: torch.optim.Optimizer, tokens: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(sharded, tokens)
        loss.backward()
        for group in plan.replicas(sharded):
            sum_replica_grads(group)
        optimizer.step()
        return loss.detach()

    return compiled(step), shard_inputs


def make_sharded_train_step(mesh: Mesh, cfg: WorkloadConfig):
    """The train step over a (dp, tp) mesh (:func:`plan_train_step` of
    :func:`shard_plan`): parameters and their AdamW moments tp-sharded, the
    batch split over dp rows, each layer recomputed in backward.  The loss
    is on the mesh's first device."""
    plan = shard_plan(mesh, cfg)
    return plan_train_step(plan, functools.partial(sharded_loss_fn, plan=plan))


def flops_per_step(cfg: WorkloadConfig) -> float:
    """Approximate training FLOPs per step (fwd+bwd ≈ 3× fwd matmul FLOPs);
    the forward that the per-layer recompute repeats is not counted."""
    T, d, f, L, B = cfg.seq, cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.batch
    attn = 2 * T * d * 3 * d + 2 * T * T * d * 2 + 2 * T * d * d
    mlp = 2 * T * d * f * 2
    per_layer = attn + mlp
    fwd = B * (L * per_layer + 2 * T * d * cfg.vocab)
    return 3.0 * fwd
