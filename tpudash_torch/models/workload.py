"""Decoder-only transformer demo workload: the counterpart of
``tpudash/models/workload.py`` on one device.

The parameter tree has the reference's names and stacked layout (leading
dim ``n_layers`` on ``blocks.*``, bf16 weights, f32 norms), and the forward
keeps every dtype point of the reference:

- RMSNorm in f32 (eps 1e-6), cast to bf16;
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
to about one layer's.  The dp×tp sharded step is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


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


def leaves(params: dict) -> list[torch.Tensor]:
    """The tree's tensors in a fixed order (the optimizer's parameter list)."""
    out = []
    for k in sorted(params):
        v = params[k]
        out += leaves(v) if isinstance(v, dict) else [v]
    return out


# --- forward ----------------------------------------------------------------

def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6)
    return (x32 * rms * scale).to(torch.bfloat16)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal scaled-dot-product attention on head-major (B, H, T, hd) bf16
    tensors."""
    T, hd = q.shape[2], q.shape[3]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (hd**-0.5)
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, -1e30)
    probs = torch.softmax(scores, dim=-1).to(torch.bfloat16)
    return torch.matmul(probs, v)


def _attention(x: torch.Tensor, wqkv: torch.Tensor, wo: torch.Tensor, cfg: WorkloadConfig) -> torch.Tensor:
    B, T, d = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    qkv = torch.matmul(x, wqkv)
    q, k, v = (t.reshape(B, T, H, hd).transpose(1, 2) for t in qkv.split(d, dim=-1))
    out = _sdpa(q, k, v)
    out = out.transpose(1, 2).reshape(B, T, d)
    return torch.matmul(out, wo)


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
        x = checkpoint(_block, x, *(b[n][layer] for n in names), cfg, use_reentrant=False)
    x = _rmsnorm(x, params["ln_f"])
    return torch.matmul(x.float(), params["unembed"].float())


def loss_fn(params: dict, tokens: torch.Tensor, cfg: WorkloadConfig) -> torch.Tensor:
    """Next-token cross-entropy (shift-by-one inside the batch)."""
    logits = forward(params, tokens[:, :-1], cfg)
    targets = tokens[:, 1:]
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None]).squeeze(-1).mean()


# --- training ---------------------------------------------------------------

def make_optimizer(params: dict, cfg: WorkloadConfig) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=0.01)``: AdamW over EVERY parameter,
    norms and embeddings included (optax masks nothing), with moments in
    the parameters' own dtype (bf16 for the weights), as optax keeps them."""
    return torch.optim.AdamW(
        leaves(params), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01
    )


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


def flops_per_step(cfg: WorkloadConfig) -> float:
    """Approximate training FLOPs per step (fwd+bwd ≈ 3× fwd matmul FLOPs);
    the forward that the per-layer recompute repeats is not counted."""
    T, d, f, L, B = cfg.seq, cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.batch
    attn = 2 * T * d * 3 * d + 2 * T * T * d * 2 + 2 * T * d * d
    mlp = 2 * T * d * f * 2
    per_layer = attn + mlp
    fwd = B * (L * per_layer + 2 * T * d * cfg.vocab)
    return 3.0 * fwd
