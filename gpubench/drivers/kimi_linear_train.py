"""Driver of the Kimi-Linear train configurations: the workload source's
``kimi-linear`` step on one GPU, steady.

The step is built as ``WorkloadRunner._loop`` builds it for that model:
``kimi_linear.make_train_step`` (one CUDA graph through
``graphed.compiled``) over the model's AdamW, with the routing counters on
the device.  One item is what the runner does between two host syncs:
``steps_per_sync`` steps dispatched back to back, then the loss read back.
The parameters (``reference/kimi_linear.py::init_params``) and a pool of
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

The window's counts: its steps, the model FLOPs a step
(``flops_kimi_linear``), the tokens each held expert took, and the KDA
calls it made with the least time of each (``flops_kimi_linear.
kda_call_bound_s``), which the KDA rooflines read.
"""

from __future__ import annotations

import math

from gpubench import compare
from gpubench import flops_kimi_linear as flops
from gpubench.reference import kimi_linear as ref


def program_config(m: dict, t: dict):
    """The program's ``KimiLinearConfig`` of configuration ``m`` and mix ``t``."""
    from tpudash_torch.models import kimi_linear as K

    la = m["linear_attn_config"]
    return K.KimiLinearConfig(
        vocab=m["vocab_size"], d_model=m["hidden_size"], n_layers=m["num_hidden_layers"],
        kda_layers=tuple(la["kda_layers"]), full_attn_layers=tuple(la["full_attn_layers"]),
        kda_heads=la["num_heads"], kda_head_dim=la["head_dim"],
        short_conv=la["short_conv_kernel_size"], gate_rank=la["head_dim"],
        n_heads=m["num_attention_heads"], qk_nope_head_dim=m["qk_nope_head_dim"],
        qk_rope_head_dim=m["qk_rope_head_dim"], v_head_dim=m["v_head_dim"],
        kv_lora_rank=m["kv_lora_rank"], first_k_dense=m["first_k_dense_replace"],
        dense_width=m["intermediate_size"], n_experts=m["num_experts_published"],
        experts_held=tuple(range(m["num_experts"])), top_k=m["num_experts_per_token"],
        expert_width=m["moe_intermediate_size"], n_shared_experts=m["num_shared_experts"],
        routed_scaling_factor=float(m["routed_scaling_factor"]), norm_eps=m["rms_norm_eps"],
        init_std=m["init_std"], seq=t["seq"], batch=t["batch"], lr=m["lr"])


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

        from tpudash_torch.models import kimi_linear as K
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
        self.optimizer = K.make_optimizer(self.params, self.cfg)
        self.counters = K.routing_counters(self.cfg, dev)
        self.step = K.make_train_step(self.cfg, dev, self.counters)
        n = self.t["check_steps"]
        losses = [self.step(self.params, self.optimizer, self.pool[0]).item()]
        first = 1.0 - self.opt["betas"][0]
        # a parameter that got no gradient has no state: its moment is 0
        moments = ref.tree((name, self.optimizer.state[p].get("exp_avg", torch.zeros_like(p)))
                           for name, p in W.named_leaves(self.params))
        grads = {k: v / first for k, v in ref.leaf_norms(moments).items()}
        del moments
        losses += [self.step(self.params, self.optimizer, self.pool[i]).item() for i in range(1, n)]
        self.readings = {"losses": losses, "grad_norms": grads,
                         "change_norms": self.change_norms(dict(W.named_leaves(self.params)))}
        self.i = n
        for _ in range(self.t["warmup_items"]):
            self.item()

    def change_norms(self, leaves: dict) -> dict:
        """Each leaf's f32 norm of its change from the run's parameters,
        which are drawn again leaf after leaf in the reference's order: one
        leaf's start at a time beside the trained state, not a second tree."""
        import torch

        dev = self.devices[0]
        g = torch.Generator(device=dev).manual_seed(self.seed)
        out = {}
        with torch.no_grad():
            for name, shape in ref.param_shapes(self.m).items():
                start = ref.init_leaf(name, shape, self.m["init_std"], g, dev)
                out[name] = (leaves[name].detach().float() - start.float()).norm().item()
        return out

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
        """The window's steps and FLOPs, its routing (tokens each held
        expert took over the window, summed over the layers: the device
        counters' difference), and its KDA calls with each one's least time."""
        now = self.counters.tolist()  # tokens a held expert over the layers, then steps
        delta = [a - b for a, b in zip(now, self.counts0)]
        steps = self.i - self.steps0
        routed = sum(delta[:-1]) / steps if steps else None
        calls = flops.kda_calls_per_step(self.m)
        return {"steps": steps, "gpus": len(self.devices),
                "flops_per_step": flops.train_flops_per_step(self.m, self.t, routed),
                "expert_tokens": delta[:-1], "counted_steps": delta[-1],
                "kda_forward_calls": steps * calls["forward"],
                "kda_backward_calls": steps * calls["backward"],
                "kda_forward_bound_s": flops.kda_call_bound_s(self.m, self.t, False),
                "kda_backward_bound_s": flops.kda_call_bound_s(self.m, self.t, True)}

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
