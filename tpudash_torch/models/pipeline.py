"""GPipe pipeline parallelism over (dp, pp), and the 3D dp×pp×tp step: the
counterpart of ``tpudash/models/pipeline.py``, driven from one process over
a ``parallel.mesh.Mesh``.

Stage s of dp row r holds layers [s·L/P, (s+1)·L/P) of the stacked tree on
its own device (the reference's ``P("pp")`` on the layer dim).  Microbatch m
goes stage to stage by a copy between devices, which autograd sees, so the
backward sends its gradient the other way.  Each layer is recomputed in
backward (``workload.checkpoint_across_devices``, as ``jax.checkpoint(block)``
in the reference).  The loss is each row's mean over its M microbatches on
its last stage, then the mean over the dp rows, on the mesh's first device.

Where the port differs from the reference, without changing the result:

- the reference's scan runs every stage on every one of its M + P − 1
  ticks, bubble ticks included, whose outputs never reach the loss.  The
  port runs only the M·P real (microbatch, stage) pairs, issued in GPipe
  order (tick t runs microbatch t − s on stage s; every forward, then the
  backward), so that work on different devices overlaps;
- the reference embeds on every stage and keeps ``ln_f`` and ``unembed``
  on every stage.  The port holds ``embed`` on each row's stage 0 and
  ``ln_f`` and ``unembed`` on its last stage (in 3D, a copy on each of
  that stage's tp devices), whose gradients are summed over the dp rows
  like every replica's (``workload.plan_train_step``), so that the copies
  stay bitwise equal.

The 3D step takes the reference's 3D tree (:func:`convert_params_3d`
splits the fused ``wqkv`` into ``wq``, ``wk`` and ``wv``).  Inside a stage
each layer runs Megatron tp over the stage's tp devices with the sharded
step's block (``workload._sharded_block``): column shard c of ``wq``, ``wk``
and ``wv`` holds whole heads (the heads must divide over tp), and the three
are joined into the head-aligned qkv shard that block takes.  As in the
reference, every tp device of a stage holds the activations and the
stage's norms: stage 0's embed on each, and ``ln_f`` and ``unembed`` on
each of the last stage's, where every column computes the loss and each
gets its gradient (the reference's "activations are tp-replicated after
each psum, so the loss is already identical across tp").  Stage s hands
column c's activations to column c of stage s + 1, as the reference's
``ppermute`` over ``pp`` does.  The reference computes all of it in plain
XLA, so there is no hand kernel here.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from tpudash_torch.models import workload as w
from tpudash_torch.parallel.collectives import one_of_replicas
from tpudash_torch.parallel.mesh import Mesh

#: a layer's tensors in ``workload._block``'s order
_LAYER = ("ln1", "wqkv", "wo", "ln2", "w_up", "w_down")
#: a 3D layer's tensors of one column, its activations first, in the order
#: :func:`_block_3d` takes each column's
_COLUMN_3D = ("h", "ln1", "ln2", "wq", "wk", "wv", "wo", "w_up", "w_down")
#: the dim of each 3D block leaf that splits over tp, None for one that the
#: stage's tp devices share (``tpudash/models/pipeline.py::_stage_param_specs_3d``:
#: q, k, v and up column-parallel, o and down row-parallel)
TP_DIMS_3D = {"ln1": None, "wq": 2, "wk": 2, "wv": 2, "wo": 1, "ln2": None, "w_up": 2, "w_down": 1}


def convert_params_3d(params: dict) -> dict:
    """The serial workload tree (or its gradients) in the 3D layout: the
    fused ``wqkv`` split into new ``wq``, ``wk`` and ``wv`` tensors; every
    other leaf is the tree's own."""
    blocks = dict(params["blocks"])
    wqkv = blocks.pop("wqkv").detach()
    d = wqkv.shape[1]
    for j, name in enumerate(("wq", "wk", "wv")):
        blocks[name] = wqkv[:, :, j * d:(j + 1) * d].clone()
    return {**params, "blocks": blocks}


@dataclass(frozen=True)
class PipelinePlan:
    """Where each parameter lives on a (dp, pp) or (dp, pp, tp) mesh, in the
    layout of ``workload.shard_params``: a leaf is a tuple over the dp rows
    of a tuple of parts.  A block leaf has one part per stage (its layers),
    or, in 3D, one per (stage, tp column) in that order, a norm's replicas
    included; ``embed`` has one part on each tp device of the row's stage
    0, ``ln_f`` and ``unembed`` one on each of its last stage's."""

    mesh: Mesh
    cfg: w.WorkloadConfig

    @property
    def dp(self) -> int:
        return self.mesh.shape["dp"]

    @property
    def pp(self) -> int:
        return self.mesh.shape["pp"]

    @property
    def tp(self) -> int:
        return self.mesh.shape.get("tp", 1)

    def device(self, row: int, stage: int = 0, col: int = 0) -> torch.device:
        return self.mesh.devices[(row * self.pp + stage) * self.tp + col]

    def _tp_dim(self, name: str) -> "int | None":
        return TP_DIMS_3D[name.split(".")[1]] if self.tp > 1 else None

    def split(self, name: str, full: torch.Tensor) -> list:
        """The parts of the full leaf ``name`` (views; a leaf the tp devices
        share, once for each)."""
        T = self.tp
        if not name.startswith("blocks."):
            return [full] * T
        dim = self._tp_dim(name)
        return [c for s in full.chunk(self.pp, 0)
                for c in ([s] * T if dim is None else s.chunk(T, dim))]

    def join(self, name: str, parts: list) -> torch.Tensor:
        """The inverse of :meth:`split`: a new full leaf on the first part's
        device, a shared leaf from its first tp column."""
        T, dev = self.tp, parts[0].device
        if not name.startswith("blocks."):
            return parts[0].clone()
        dim = self._tp_dim(name)
        stages = [parts[s * T] if dim is None
                  else torch.cat([p.to(dev) for p in parts[s * T:(s + 1) * T]], dim)
                  for s in range(self.pp)]
        return torch.cat([s.to(dev) for s in stages], 0)

    def part_device(self, name: str, row: int, i: int) -> torch.device:
        """The device of part ``i`` of leaf ``name`` in dp row ``row``."""
        if name == "embed":
            return self.device(row, 0, i)
        if not name.startswith("blocks."):
            return self.device(row, self.pp - 1, i)
        return self.device(row, *divmod(i, self.tp))

    def replicas(self, sharded: dict) -> list:
        """Each part over the dp rows."""
        return w.row_replicas(sharded)


def pipeline_plan(mesh: Mesh, cfg: w.WorkloadConfig) -> PipelinePlan:
    """The plan of ``cfg`` on a (dp, pp) mesh, or on a (dp, pp, tp) mesh for
    the 3D step.  The reference's checks raise ValueError with its messages;
    a d_ff that does not split over tp raises as the sharded step's plan
    does.  Nothing is resized."""
    if mesh.axis_names not in (("dp", "pp"), ("dp", "pp", "tp")):
        raise ValueError(f"the pipeline needs a (dp, pp) or (dp, pp, tp) mesh, not {mesh.axis_names}")
    plan = PipelinePlan(mesh, cfg)
    if cfg.n_layers % plan.pp:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by pp={plan.pp}")
    if cfg.n_heads % plan.tp:
        raise ValueError(f"n_heads={cfg.n_heads} not divisible by tp={plan.tp}")
    if cfg.d_ff % plan.tp:
        raise ValueError(f"d_ff {cfg.d_ff} does not split over the tp axis of size {plan.tp}")
    return plan


def _layer(cfg: w.WorkloadConfig, h: torch.Tensor, *weights) -> torch.Tensor:
    return w._block(h, *weights, cfg)


def _block_3d(cfg: w.WorkloadConfig, *tensors) -> tuple:
    """One layer over a stage's tp devices: ``tensors`` are each column's
    in ``_COLUMN_3D`` order, column after column, each on its device."""
    fused = []
    for i in range(0, len(tensors), len(_COLUMN_3D)):
        h, ln1, ln2, wq, wk, wv, wo, w_up, w_down = tensors[i:i + len(_COLUMN_3D)]
        fused += [h, ln1, ln2, torch.cat([wq, wk, wv], -1), wo, w_up, w_down]
    return w._sharded_block(cfg, True, *fused)


def _run_stage(plan: PipelinePlan, sharded: dict, row: int, stage: int, xs: list) -> list:
    """Stage ``stage`` of dp row ``row`` on the activations ``xs``, one
    replica on each of the stage's tp devices: its layers in order, each
    recomputed in backward."""
    b, cfg, T = sharded["blocks"], plan.cfg, plan.tp
    for j in range(cfg.n_layers // plan.pp):
        if T == 1:
            xs = [w.checkpoint_across_devices(functools.partial(_layer, cfg), xs[0],
                                              *(b[n][row][stage][j] for n in _LAYER))]
        else:
            xs = list(w.checkpoint_across_devices(functools.partial(_block_3d, cfg), *(
                t for c in range(T)
                for t in (xs[c], *(b[n][row][stage * T + c][j] for n in _COLUMN_3D[1:])))))
    return xs


def pipeline_loss_fn(sharded: dict, tokens: torch.Tensor, plan: PipelinePlan,
                     num_microbatches: int) -> torch.Tensor:
    """Next-token cross-entropy of the pipelined forward on the mesh's first
    device: the batch splits over the dp rows, each row's over M
    microbatches."""
    dp, pp, M = plan.dp, plan.pp, num_microbatches
    B = tokens.shape[0]
    if B % dp:
        raise ValueError(f"batch {B} does not split over the dp axis of size {dp}")
    if (B // dp) % M:
        raise ValueError(f"local batch {B // dp} not divisible by microbatches {M}")
    rows = [t.to(plan.device(r)) for r, t in enumerate(tokens.chunk(dp, 0))]
    # acts[r][m][c]: row r's microbatch m on tp column c of its stage
    acts = [list(zip(*(e[t[:, :-1].to(e.device)].chunk(M, 0) for e in sharded["embed"][r])))
            for r, t in enumerate(rows)]
    # GPipe order: at tick t stage s runs microbatch t − s, which stage s − 1
    # ran at tick t − 1
    for tick in range(M + pp - 1):
        for r in range(dp):
            for s in range(max(0, tick - M + 1), min(pp, tick + 1)):
                xs = [x.to(plan.device(r, s, c)) for c, x in enumerate(acts[r][tick - s])]
                acts[r][tick - s] = _run_stage(plan, sharded, r, s, xs)
    dev0 = plan.device(0)
    losses = []
    for r, t in enumerate(rows):
        per_column = []
        for c, (ln_f, unembed) in enumerate(zip(sharded["ln_f"][r], sharded["unembed"][r])):
            h = w._rmsnorm(torch.cat([a[c] for a in acts[r]], 0), ln_f).float()
            logp = torch.log_softmax(torch.matmul(h, unembed.float()), dim=-1)
            targets = t[:, 1:].to(h.device)
            per_column.append(-logp.gather(-1, targets[..., None]).squeeze(-1).mean())
        losses.append(one_of_replicas(per_column).to(dev0))
    return torch.stack(losses).mean()


def _pipeline(mesh: Mesh, cfg: w.WorkloadConfig, num_microbatches: int, axes: tuple):
    if mesh.axis_names != axes:
        raise ValueError(f"this step needs a {axes} mesh, not {mesh.axis_names}")
    plan = pipeline_plan(mesh, cfg)
    return plan, functools.partial(pipeline_loss_fn, plan=plan, num_microbatches=num_microbatches)


def make_pipeline_loss(mesh: Mesh, cfg: w.WorkloadConfig, num_microbatches: int):
    """``loss(sharded, tokens)`` of the pipeline over a (dp, pp) mesh, the
    parameters sharded by ``workload.shard_params(params,
    pipeline_plan(mesh, cfg))``."""
    return _pipeline(mesh, cfg, num_microbatches, ("dp", "pp"))[1]


def make_pipeline3d_loss(mesh: Mesh, cfg: w.WorkloadConfig, num_microbatches: int):
    """``loss(sharded, tokens)`` of the 3D step over a (dp, pp, tp) mesh, on
    the 3D tree sharded by ``workload.shard_params(convert_params_3d(params),
    pipeline_plan(mesh, cfg))``."""
    return _pipeline(mesh, cfg, num_microbatches, ("dp", "pp", "tp"))[1]


def make_pipeline_train_step(mesh: Mesh, cfg: w.WorkloadConfig, num_microbatches: int = 4):
    """The pipelined train step over a (dp, pp) mesh, driven from one
    process (``workload.plan_train_step``): ``(step, shard_inputs)`` as the
    sharded step has them, ``shard_inputs`` taking the full tree and its
    optimizer, or None."""
    return w.plan_train_step(*_pipeline(mesh, cfg, num_microbatches, ("dp", "pp")))


def make_pipeline3d_train_step(mesh: Mesh, cfg: w.WorkloadConfig, num_microbatches: int = 2):
    """The dp×pp×tp train step, as :func:`make_pipeline_train_step`;
    ``shard_inputs`` takes the 3D tree (:func:`convert_params_3d`) and an
    optimizer over it, or None."""
    return w.plan_train_step(*_pipeline(mesh, cfg, num_microbatches, ("dp", "pp", "tp")))
