"""Driver of the train configurations: the workload source's train step,
steady.

The step is built as ``WorkloadRunner._loop`` builds it for n ≥ 2 GPUs:
``make_sharded_train_step`` on ``build_mesh(mesh_axes_for(n))`` with
``shard_inputs``.  (No cell runs the runner's one-GPU step.)  One item is
what the runner does between two host syncs: ``steps_per_sync`` steps
dispatched back to back, then the loss read back.  The parameters and a
pool of token batches are made from ``--seed`` by the harness; the window
cycles through the pool.

Set-up drives the same step object through its first ``check_steps`` calls,
which capture its graph, on pool batches 0, 1, 2, and reads what the
reference will be held against: each step's loss, every parameter's first
gradient as AdamW got it (its first moment after one step over ``1 −
β1``), and every parameter's change over the three steps.  After the window
the reference follows the same three steps from the same parameters, and
every replica of a replicated parameter (a norm's scale on each tp column)
is held to the first, exactly.
"""

from __future__ import annotations

import math

from gpubench import compare, inputs, peaks
from gpubench.reference import transformer as ref


class Driver:
    def __init__(self, cell, seed: int, devices: list):
        self.cell, self.seed, self.devices = cell, seed, devices
        self.m = cell.config["model"]
        self.opt = cell.config["optimizer"]
        self.t = cell.traffic

    def build(self):
        """(step, params, optimizer) as the runner makes them, over the
        harness's parameters; the full tree it started from."""
        import torch

        from tpudash_torch.models import workload as W
        from tpudash_torch.parallel import mesh as M

        if len(self.devices) < 2:
            raise ValueError("the train driver runs the sharded step: give it 2 devices or more")
        cfg = W.WorkloadConfig(**self.m)
        params = inputs.model_params(self.m, self.seed, self.devices[0])
        self.shapes = {n: t.shape for n, t in ref.named_leaves(params)}
        mesh = M.build_mesh(M.mesh_axes_for(len(self.devices)), self.devices)
        step, shard_inputs = W.make_sharded_train_step(mesh, cfg)
        state, opt = shard_inputs(params, None)
        plan = W.shard_plan(mesh, cfg)

        def full(kind: str):
            if kind == "params":
                return W.gather_params(state, plan)
            moments = W.gather_optimizer_state(opt, state, plan)["state"]
            named = ref.named_leaves(params)
            return ref.tree((n, moments[i]["exp_avg"] if i in moments else torch.zeros_like(t))
                            for i, (n, t) in enumerate(named))

        return step, state, opt, params, full

    def tokens(self):
        """The run's pool of token batches, (n, batch, seq) on the first GPU."""
        return inputs.token_pool(self.m, self.t["token_pool_batches"], self.seed, self.devices[0])

    def setup(self) -> None:
        L = self.m["n_layers"]
        self.pool = self.tokens()
        self.step, self.state, self.optimizer, start, full = self.build()
        n = self.t["check_steps"]
        losses = [self.step(self.state, self.optimizer, self.pool[0]).item()]
        first = 1.0 - self.opt["betas"][0]
        grads = ref.leaf_norms(full("moments"), L)
        grads = {k: v / first for k, v in grads.items()}
        losses += [self.step(self.state, self.optimizer, self.pool[i]).item() for i in range(1, n)]
        after = full("params")
        change = ref.tree((name, a.detach().float() - b.float()) for (name, a), (_, b)
                          in zip(ref.named_leaves(after), ref.named_leaves(start)))
        self.readings = {"losses": losses, "grad_norms": grads,
                         "change_norms": ref.leaf_norms(change, L)}
        del start, after, change
        self.i = n
        for _ in range(self.t["warmup_items"]):
            self.item()

    def start_window(self) -> None:
        self.steps0 = self.i

    def item(self) -> tuple:
        """``steps_per_sync`` steps, then one readback: (tokens fed, finite loss)."""
        k, pool = self.t["steps_per_sync"], self.pool
        for _ in range(k):
            loss = self.step(self.state, self.optimizer, pool[self.i % len(pool)])
            self.i += 1
        return k * self.m["batch"] * self.m["seq"], math.isfinite(loss.item())

    def window_counts(self) -> dict:
        return {"steps": self.i - self.steps0, "gpus": len(self.devices),
                "flops_per_step": peaks.train_flops_per_step(**self.m)}

    def free(self) -> None:
        self.replica_gap = self.replicas_apart()
        self.step = self.state = self.optimizer = None

    def replicas_apart(self) -> float:
        """The largest gap between a replica of a parameter and the first
        replica of it, over every parameter whose parts all have its full
        shape (a replica on each device of its row or column); the state as
        the window left it."""
        gap = 0.0
        for name, rows in ref.named_leaves(self.state):
            parts = [p for row in rows for p in row]
            if all(p.shape == self.shapes[name] for p in parts):
                first = parts[0].detach()
                for p in parts[1:]:
                    diff = (p.detach().to(first.device) - first).abs().max().item()
                    gap = max(gap, diff if diff == diff else math.inf)
        return gap

    def reference(self, precision: str = "bf16", rows: "slice | None" = None) -> dict:
        """The reference's three steps from the run's parameters and batches;
        ``rows`` keeps part of each batch (a planted fault)."""
        dev = self.devices[0]
        params = inputs.model_params(self.m, self.seed, dev)
        batches = list(self.pool[:self.t["check_steps"]])
        if rows is not None:
            batches = [b[rows] for b in batches]
        return ref.train_steps(params, batches, self.m, self.opt, precision)

    @staticmethod
    def numbers(got: dict, want: dict) -> dict:
        names = compare.moved(want["grad_norms"])
        return {
            "loss_gap": compare.loss_gap(got["losses"], want["losses"]),
            "grad_norm_gap": compare.norm_gap(got["grad_norms"], want["grad_norms"], names),
            "change_norm_gap": compare.norm_gap(got["change_norms"], want["change_norms"], names),
        }

    def check(self) -> dict:
        return {**self.numbers(self.readings, self.reference()), "replica_gap": self.replica_gap}
