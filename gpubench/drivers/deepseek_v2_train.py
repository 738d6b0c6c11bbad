"""Driver of the DeepSeek-V2-Lite train configurations: the workload
source's ``deepseek-v2-lite`` step on one GPU, steady.

The step is built as ``WorkloadRunner._loop`` builds it for that model:
``deepseek_v2.make_train_step`` (one CUDA graph through
``graphed.compiled``) over the model's AdamW, with the routing counters on
the device.  One item is what the runner does between two host syncs:
``steps_per_sync`` steps dispatched back to back, then the loss read back.
The parameters (``reference/deepseek_v2.py::init_params``) and a pool of
token batches, ids drawn from a Zipf law over the vocabulary slice, are
made from ``--seed`` by the harness; the window cycles through the pool.

Set-up drives the same step object through its first ``check_steps``
calls, which capture its graph, on pool batches 0, 1, 2, and reads what the
reference will be held against: each step's loss, every parameter's first
gradient as AdamW got it (its first moment after one step over ``1 −
β1``), and every parameter's change over the three steps; a parameter is a
leaf of the tree (``reference.leaf_norms``).  After the window the
program's state is freed, and the reference follows the same three steps
from the same parameters in f32.
"""

from __future__ import annotations

import math

from gpubench import compare
from gpubench import flops_deepseek_v2 as flops
from gpubench.reference import deepseek_v2 as ref


def program_config(m: dict, t: dict):
    """The program's ``DeepseekV2Config`` of configuration ``m`` and mix ``t``."""
    from tpudash_torch.models import deepseek_v2 as D

    rs = m["rope_scaling"]
    return D.DeepseekV2Config(
        vocab=m["vocab_size"], d_model=m["hidden_size"], n_heads=m["num_attention_heads"],
        qk_nope_head_dim=m["qk_nope_head_dim"], qk_rope_head_dim=m["qk_rope_head_dim"],
        v_head_dim=m["v_head_dim"], kv_lora_rank=m["kv_lora_rank"],
        n_layers=m["num_hidden_layers"], first_k_dense=m["first_k_dense_replace"],
        dense_width=m["intermediate_size"], n_experts=m["n_routed_experts_published"],
        experts_held=tuple(range(m["n_routed_experts"])), top_k=m["num_experts_per_tok"],
        expert_width=m["moe_intermediate_size"], n_shared_experts=m["n_shared_experts"],
        norm_topk_prob=m["norm_topk_prob"], routed_scaling_factor=float(m["routed_scaling_factor"]),
        aux_loss_alpha=m["aux_loss_alpha"], rope_theta=float(m["rope_theta"]),
        rope_factor=float(rs["factor"]),
        original_max_position_embeddings=rs["original_max_position_embeddings"],
        beta_fast=float(rs["beta_fast"]), beta_slow=float(rs["beta_slow"]),
        mscale=rs["mscale"], mscale_all_dim=rs["mscale_all_dim"], init_std=m["init_std"],
        seq=t["seq"], batch=t["batch"], lr=m["lr"])


def zipf_pool(n: int, batch: int, seq: int, vocab: int, exponent: float, seed: int, device):
    """``n`` batches of token ids (n, batch, seq) int64: ranks drawn with
    P(r) ∝ r^−exponent over the vocabulary, each rank an id of a random
    permutation of it; all from ``seed``."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed + 1)
    ids = torch.randperm(vocab, generator=g, device=device)
    p = torch.arange(1, vocab + 1, device=device, dtype=torch.float64) ** -exponent
    ranks = torch.multinomial(p.float(), n * batch * seq, replacement=True, generator=g)
    return ids[ranks].view(n, batch, seq)


class Driver:
    def __init__(self, cell, seed: int, devices: list):
        self.cell, self.seed, self.devices = cell, seed, devices
        self.m = cell.config
        self.opt = cell.config["optimizer"]
        self.t = cell.traffic

    def tokens(self):
        t = self.t
        return zipf_pool(t["token_pool_batches"], t["batch"], t["seq"], self.m["vocab_size"],
                         t["zipf_exponent"], self.seed, self.devices[0])

    def setup(self) -> None:
        import torch

        from tpudash_torch.models import deepseek_v2 as D
        from tpudash_torch.models import workload as W

        if len(self.devices) != 1:
            raise ValueError(f"the {self.m['kind']} driver runs on one device, "
                             f"not {len(self.devices)}")
        dev = self.devices[0]
        self.cfg = program_config(self.m, self.t)
        self.pool = self.tokens()
        self.params = ref.init_params(self.m, self.seed, dev)
        for p in W.leaves(self.params):
            p.requires_grad_(True)
        self.optimizer = D.make_optimizer(self.params, self.cfg)
        self.counters = D.routing_counters(self.cfg, dev)
        self.step = D.make_train_step(self.cfg, dev, self.counters)
        n = self.t["check_steps"]
        losses = [self.step(self.params, self.optimizer, self.pool[0]).item()]
        first = 1.0 - self.opt["betas"][0]
        # a parameter that got no gradient has no state: its moment is 0
        moments = ref.tree((name, self.optimizer.state[p].get("exp_avg", torch.zeros_like(p)))
                           for name, p in W.named_leaves(self.params))
        grads = {k: v / first for k, v in ref.leaf_norms(moments).items()}
        del moments
        losses += [self.step(self.params, self.optimizer, self.pool[i]).item() for i in range(1, n)]
        start = ref.init_params(self.m, self.seed, dev)
        with torch.no_grad():
            change = ref.tree((name, p.detach().float() - s.float()) for (name, p), (_, s)
                              in zip(W.named_leaves(self.params), ref.named_leaves(start)))
            change_norms = ref.leaf_norms(change)
        del start, change
        self.readings = {"losses": losses, "grad_norms": grads, "change_norms": change_norms}
        self.i = n
        for _ in range(self.t["warmup_items"]):
            self.item()

    def start_window(self) -> None:
        self.steps0 = self.i
        self.counts0 = self.counters.tolist()

    def item(self) -> tuple:
        """``steps_per_sync`` steps, then one readback: (tokens fed, finite loss)."""
        k, pool = self.t["steps_per_sync"], self.pool
        for _ in range(k):
            loss = self.step(self.params, self.optimizer, pool[self.i % len(pool)])
            self.i += 1
        return k * self.t["batch"] * self.t["seq"], math.isfinite(loss.item())

    def window_counts(self) -> dict:
        """The window's steps and FLOPs, and its routing: tokens each held
        expert took over the window, summed over the layers (the device
        counters' difference; its step count is the window's)."""
        now = self.counters.tolist()  # tokens a held expert over the layers, then steps
        delta = [a - b for a, b in zip(now, self.counts0)]
        steps = self.i - self.steps0
        routed = sum(delta[:-1]) / steps if steps else None
        return {"steps": steps, "gpus": len(self.devices),
                "flops_per_step": flops.train_flops_per_step(self.m, self.t, routed),
                "expert_tokens": delta[:-1], "counted_steps": delta[-1]}

    def free(self) -> None:
        self.step = self.params = self.optimizer = None

    def reference(self, precision: str = "bf16", rows: "slice | None" = None) -> dict:
        """The reference's three steps from the run's parameters and batches;
        ``rows`` keeps part of each batch (a planted fault)."""
        dev = self.devices[0]
        params = ref.init_params(self.m, self.seed, dev)
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
        return self.numbers(self.readings, self.reference())
