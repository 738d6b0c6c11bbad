"""Expert parallelism: switch (top-1) and top-k MoE over an ``ep`` axis, the
counterpart of ``tpudash/models/moe.py``, driven from one process over a
``parallel.mesh.Mesh``.

Experts are split over the ``ep`` slots (slot g holds experts
g·E/G … (g+1)·E/G − 1); the embedding, router, norm and unembedding are
replicated on every slot.  The ep axis is also the token-group axis: slot g
routes its own S tokens with its own capacity ``C = ceil(K·S/E · cf)``.
Routing is the reference's dense formulation: one-hot dispatch and combine
tensors of shape (S, E, C), built in f32, and products with them.  The two
``lax.all_to_all`` exchanges become copies of (E/G, C, d) blocks between the
slots' devices, which autograd sees and carries back in the backward pass.
No NCCL, so that the path runs on one card named several times.

Kept from the reference, where PyTorch's defaults differ:

- ``lax.top_k`` breaks ties by the lower index (a zero router sends every
  token to expert 0); ``torch.topk`` promises no order, so the top k are
  the first k of a stable descending sort;
- ``jax.nn.one_hot`` gives a zero row for a position at or past the
  capacity, where ``F.one_hot`` raises, so the capacity one-hot compares
  with ``arange(C)``;
- the down-projection is an f32 product of f32-cast operands; TF32 stays
  off (PyTorch's default), so that it is one.

The reference computes all of it in plain XLA, so there is no hand kernel
here.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from tpudash_torch.models import workload as w
from tpudash_torch.parallel.mesh import Mesh


@dataclass(frozen=True)
class MoEConfig:
    vocab: int = 128
    d_model: int = 64
    d_ff: int = 128
    n_experts: int = 8
    seq: int = 16
    batch: int = 8
    #: experts per token: 1 = switch routing, 2 = Mixtral-style top-2
    #: (gates renormalized over the chosen experts).
    top_k: int = 1
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    lr: float = 3e-4


def init_moe_params(cfg: MoEConfig, generator: torch.Generator) -> dict:
    """Expert-stacked parameters at the reference's shapes, scales and
    dtypes (bf16 weights, the router and the norm in f32), drawn from
    ``generator`` on its device; :func:`workload.params_from_numpy` carries
    the reference's own draws across."""
    dev = generator.device
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=dev, dtype=torch.float32) * scale

    return {
        "embed": normal((cfg.vocab, d), 0.02).to(torch.bfloat16),
        "router": normal((d, E), d**-0.5),
        "w_up": normal((E, d, f), d**-0.5).to(torch.bfloat16),
        "w_down": normal((E, f, d), f**-0.5).to(torch.bfloat16),
        "ln": torch.ones((d,), dtype=torch.float32, device=dev),
        "unembed": normal((d, cfg.vocab), d**-0.5).to(torch.bfloat16),
    }


#: the dim of each leaf that splits over ep, None for a leaf every slot
#: holds whole (``tpudash/models/moe.py::moe_param_specs``)
EP_DIMS = {"embed": None, "router": None, "w_up": 0, "w_down": 0, "ln": None, "unembed": None}


@dataclass(frozen=True)
class MoEPlan:
    """Where each parameter lives on an (ep,) mesh, in the layout of
    ``workload.shard_params`` with one row: a leaf is a tuple holding a tuple
    over the ep slots of slot g's part, its experts' block of an expert leaf
    or its own copy of a replicated one."""

    mesh: Mesh
    cfg: MoEConfig
    dp = 1

    @property
    def ep(self) -> int:
        return self.mesh.shape["ep"]

    def device(self, slot: int = 0) -> torch.device:
        return self.mesh.devices[slot]

    def split(self, name: str, full: torch.Tensor) -> list:
        return [full] * self.ep if EP_DIMS[name] is None else list(full.chunk(self.ep, 0))

    def join(self, name: str, parts: list) -> torch.Tensor:
        parts = [p.to(parts[0].device) for p in parts]
        return parts[0].clone() if EP_DIMS[name] is None else torch.cat(parts, 0)

    def part_device(self, name: str, row: int, i: int) -> torch.device:
        return self.device(i)

    def replicas(self, sharded: dict) -> list:
        """Every slot's copy of each replicated leaf."""
        return [list(rows[0]) for name, rows in w.named_leaves(sharded) if EP_DIMS[name] is None]


def moe_plan(mesh: Mesh, cfg: MoEConfig) -> MoEPlan:
    if mesh.axis_names != ("ep",):
        raise ValueError(f"the MoE step needs an (ep,) mesh, not {mesh.axis_names}")
    G = mesh.shape["ep"]
    if cfg.n_experts % G:
        raise ValueError(f"n_experts={cfg.n_experts} not divisible by ep={G}")
    return MoEPlan(mesh, cfg)


def _capacity(tokens_per_group: int, cfg: MoEConfig) -> int:
    # K·S assignments spread over E experts (GShard convention)
    return max(1, math.ceil(cfg.top_k * tokens_per_group / cfg.n_experts * cfg.capacity_factor))


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest along the last dim, ties to the lower
    index."""
    values, index = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def _gates(x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig):
    """(router probabilities (S, E), top-k gates (S, K), top-k experts)."""
    probs = torch.softmax(torch.matmul(x.float(), router), dim=-1)
    gates, experts = _top_k(probs, cfg.top_k)
    if cfg.top_k > 1:  # Mixtral renormalizes over the chosen experts
        gates = gates / gates.sum(-1, keepdim=True)
    return probs, gates, experts


def _route(x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig, capacity: int):
    """Top-k routing of local tokens x (S, d) → (dispatch (S, E, C), combine
    (S, E, C), aux-loss scalar), all f32.  Capacity positions go choice-rank
    first (every primary assignment, then the secondary), so a full expert
    drops secondary traffic before primary."""
    E, K = cfg.n_experts, cfg.top_k
    probs, gates, experts = _gates(x, router, cfg)
    slots = torch.arange(capacity, device=x.device, dtype=torch.float32)
    ids = torch.arange(E, device=x.device)
    dispatch = torch.zeros((x.shape[0], E, capacity), dtype=torch.float32, device=x.device)
    combine = torch.zeros_like(dispatch)
    usage = torch.zeros((E,), dtype=torch.float32, device=x.device)  # slots taken per expert
    frac = torch.zeros((E,), dtype=torch.float32, device=x.device)
    for j in range(K):
        mask = (experts[:, j, None] == ids).float()  # (S, E)
        pos = torch.cumsum(mask, 0) * mask - mask + usage * mask
        keep = mask * (pos < capacity).float()
        d_j = keep[..., None] * (pos[..., None] == slots).float()  # zero past the capacity
        dispatch = dispatch + d_j
        combine = combine + d_j * gates[:, j, None, None]
        usage = usage + keep.sum(0)
        frac = frac + mask.mean(0)
    # load-balance aux: E · Σ_e (assigned fraction_e / K · mean prob_e)
    aux = E * torch.sum(frac / K * probs.mean(0))
    return dispatch, combine, aux


def moe_ffn(xs: list, slots: list, cfg: MoEConfig) -> tuple[list, list]:
    """The expert FFN over every ep slot (``moe_ffn_local`` on each shard of
    the reference): ``xs[g]`` (S, d) are slot g's tokens on its device,
    ``slots[g]`` its parameters (``router`` and its experts' ``w_up`` and
    ``w_down``).  Returns each slot's (S, d) output in x's dtype and its aux
    loss."""
    G, E = len(xs), cfg.n_experts
    devs = [x.device for x in xs]
    sent, combines, auxs = [], [], []
    for x, p in zip(xs, slots):
        S, d = x.shape
        C = _capacity(S, cfg)
        dispatch, combine, aux = _route(x, p["router"], cfg, C)
        # expert-major send buffer, dim 0 the slot that owns the experts
        sent.append(torch.einsum("sec,sd->ecd", dispatch, x.float()).reshape(G, E // G, C, d))
        combines.append(combine)
        auxs.append(aux)
    outs = []
    for h, p in enumerate(slots):
        # recv[src] = source src's tokens for slot h's experts
        recv = torch.stack([sent[src][h].to(devs[h]) for src in range(G)])
        up = F.gelu(torch.einsum("gecd,edf->gecf", recv.to(torch.bfloat16), p["w_up"]),
                    approximate="tanh")
        outs.append(torch.einsum("gecf,efd->gecd", up.float(), p["w_down"].float()))
    ys = []
    for g, (x, combine) in enumerate(zip(xs, combines)):
        # the return trip: every expert's output for slot g's tokens
        back = torch.cat([outs[h][g].to(devs[g]) for h in range(G)])
        ys.append(torch.einsum("sec,ecd->sd", combine, back).to(x.dtype))
    return ys, auxs


def moe_loss_fn(sharded: dict, tokens: torch.Tensor, plan: MoEPlan) -> torch.Tensor:
    """Embed → residual MoE block → unembed on each slot's tokens, and the
    mean over the slots of each one's next-token cross-entropy plus
    ``router_aux_weight`` times its aux loss, on the mesh's first device."""
    cfg, G = plan.cfg, plan.ep
    if tokens.shape[0] % G:
        raise ValueError(f"batch {tokens.shape[0]} does not split over the ep axis of size {G}")
    slots = [{name: rows[0][g] for name, rows in sharded.items()} for g in range(G)]
    rows = [t.to(plan.device(g)) for g, t in enumerate(tokens.chunk(G, 0))]
    xs = [p["embed"][t[:, :-1]].reshape(-1, cfg.d_model) for t, p in zip(rows, slots)]
    ys, auxs = moe_ffn([w._rmsnorm(x, p["ln"]) for x, p in zip(xs, slots)], slots, cfg)
    dev0, losses = plan.device(0), []
    for t, p, x, y, aux in zip(rows, slots, xs, ys, auxs):
        logp = torch.log_softmax(torch.matmul((x + y).float(), p["unembed"].float()), dim=-1)
        nll = -logp.gather(-1, t[:, 1:].reshape(-1, 1)).mean()
        losses.append((nll + cfg.router_aux_weight * aux).to(dev0))
    return torch.stack(losses).mean()


def make_moe_loss(mesh: Mesh, cfg: MoEConfig):
    """``loss(sharded, tokens)`` over an (ep,) mesh, the parameters sharded
    by ``workload.shard_params(params, moe_plan(mesh, cfg))``."""
    return functools.partial(moe_loss_fn, plan=moe_plan(mesh, cfg))


def make_moe_train_step(mesh: Mesh, cfg: MoEConfig):
    """The expert-parallel train step, driven from one process
    (``workload.plan_train_step``): ``(step, shard_inputs)`` as the sharded
    step has them.  The replicated leaves' gradients are summed over the
    slots; each expert's arrives whole through the exchanges."""
    plan = moe_plan(mesh, cfg)
    return w.plan_train_step(plan, functools.partial(moe_loss_fn, plan=plan))


def make_moe_train_state(cfg: MoEConfig, generator: torch.Generator):
    """(params, AdamW(lr, weight_decay 0.01) over them); the parameters
    require grad."""
    params = init_moe_params(cfg, generator)
    for p in params.values():
        p.requires_grad_(True)
    return params, w.make_optimizer(params, cfg)


# --- correctness oracle ------------------------------------------------------

def dense_moe_reference(x: torch.Tensor, params: dict, cfg: MoEConfig) -> torch.Tensor:
    """Per-token oracle: y[s] = Σ_j gate_j[s] · FFN_{expert_j(s)}(x[s]), no
    capacity drops, with the reference's dtype points.  The tokens of one
    expert go through it together rather than gathering an expert's weights
    per token."""
    _, gates, experts = _gates(x, params["router"], cfg)
    y = torch.zeros((x.shape[0], cfg.d_model), dtype=torch.float32, device=x.device)
    xb = x.to(torch.bfloat16)
    for j in range(cfg.top_k):
        for e in range(cfg.n_experts):
            sel = torch.nonzero(experts[:, j] == e).squeeze(1)
            h = F.gelu(torch.matmul(xb[sel], params["w_up"][e]), approximate="tanh")
            yj = torch.matmul(h.float(), params["w_down"][e].float())
            y = y.index_add(0, sel, gates[sel, j, None] * yj)
    return y.to(x.dtype)
