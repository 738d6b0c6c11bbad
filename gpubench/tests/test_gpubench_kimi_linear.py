"""The Kimi-Linear cell at a size the CPU runs: its driver runs the cell end
to end, each planted fault and the precision control make ``correct``
false, its frozen counts are the program's and the kernels', its files
import no JAX, and its entries in ``BENCHMARK.json`` resolve.

The shrunk configuration keeps the published structure (3 KDA layers then
one NoPE MLA layer, one dense layer then MoE, a sigmoid router over 16
experts with 8 held, top-3, 1 shared expert) and the cell's init at d 64,
4 layers, KDA 2 heads of 16, batch 4 × seq 80.  Its limits are set as the
cell's are (``calibrate_kimi_linear.readings`` on the CPU): sound runs of 8
seeds read at most loss 7.4e-5, gradient norms 0.193, change 0.148 (the
worst leaf of both a KDA layer's ``A_log``: its gradient, a sum over every
position and channel of a head, cancels, and the bf16 step's share of it
is noisy); the fp8 control (2 seeds) at least loss 1.97e-4, gradient
0.102, change 0.087; the faults (2 seeds) at least: decay a head's mean
gradient 1.38, β fixed at 1 gradient 2.64, short convolution left out
gradient 1.41, q/k L2 norm left out gradient 5.45, output gate left out
gradient 1.0, top-k gates not renormalised gradient 1.06 (its loss, 4.1e-5,
does not tell), half batches gradient 1.39.  The scan in bf16 (2 seeds)
reads as a sound run does here (loss 1.03e-4, gradient 0.059, change
0.056: two chunks carry little rounding), so these tests only check that
it is planted where the step calls the chunked rule.
"""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from gpubench import calibrate_kimi_linear as cal
from gpubench import compare, manifest
from gpubench import flops_kimi_linear as flops
from gpubench.run import execute

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

CELL = "kimi-linear-ep16.1gpu"
TINY_MODEL = {"hidden_size": 64, "num_attention_heads": 4, "qk_nope_head_dim": 16,
              "qk_rope_head_dim": 8, "v_head_dim": 16, "kv_lora_rank": 32,
              "num_experts_published": 16, "num_experts": 8, "num_experts_per_token": 3,
              "moe_intermediate_size": 24, "num_hidden_layers": 4, "intermediate_size": 96,
              "vocab_size": 128,
              "linear_attn_config": {"kda_layers": [1, 2, 3], "full_attn_layers": [4],
                                     "num_heads": 2, "head_dim": 16, "short_conv_kernel_size": 4},
              "limits": {"loss_gap": 1.2e-4, "grad_norm_gap": 0.5, "change_norm_gap": 0.25}}
TINY_TRAFFIC = {"seq": 80, "batch": 4}
SEED = 2**31 + 11


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def kimi_base(tmp_path_factory):
    base = tmp_path_factory.mktemp("gpubench_kimi")
    for d in ("configs", "traffic", "drivers", "metrics"):
        shutil.copytree(BENCH / d, base / d)
    for path, change in ((base / "configs" / "kimi-linear-ep16.json", TINY_MODEL),
                         (base / "traffic" / "train-zipf-8k.json", TINY_TRAFFIC)):
        path.write_text(json.dumps({**json.loads(path.read_text()), **change}))
    return base


@pytest.fixture(scope="module")
def cell(kimi_base, bench_manifest):
    return manifest.find_cell(bench_manifest, CELL, kimi_base)


def _run(cell, base, seed=SEED, trace=False) -> dict:
    return execute(cell, seed, [torch.device("cpu")], 0.3, trace, time.perf_counter(), base)


@pytest.mark.parametrize("trace", [False, True], ids=["end_to_end", "per_layer"])
def test_a_sound_run_of_the_cell_is_correct(cell, kimi_base, trace):
    r = _run(cell, kimi_base, trace=trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r["checks"]) == ["loss_gap", "grad_norm_gap", "change_norm_gap"]
    counts = r["counts"]
    assert counts["counted_steps"] == counts["steps"] > 0 and len(counts["expert_tokens"]) == 8
    assert counts["kda_forward_calls"] == 6 * counts["steps"]
    assert counts["kda_backward_calls"] == 3 * counts["steps"]
    if trace:  # the CPU run has no device trace: every per-layer metric is silent
        assert r["metrics"] == {}
    else:
        assert set(r["metrics"]) == {"setup_s", "train_tokens_per_s"}


@pytest.mark.parametrize("fault", cal.FAULTS)
def test_a_planted_fault_is_not_correct(cell, kimi_base, fault):
    with cal.planted(fault):
        r = _run(cell, kimi_base)
    assert not r["correct"], r["checks"]


def test_the_scan_in_bf16_is_planted_where_the_step_calls_the_chunked_rule():
    """Under the fault ``kernels.kda_chunk`` gives bf16's rounding (2^-8
    relative, read 3.1e-3 to 3.6e-3 over three seeds) where the f32 chain
    gives f32's, its gradients stay finite, and the kernels come back after."""
    from tpudash_torch.ops import kernels

    g = torch.Generator().manual_seed(7)
    B, T, H, D = 2, 150, 2, 8
    q, k = (F.normalize(torch.randn(B, T, H, D, generator=g), dim=-1) for _ in range(2))
    v = torch.randn(B, T, H, D, generator=g)
    decay = -0.5 * torch.rand(B, T, H, D, generator=g)
    inputs = [x.requires_grad_(True) for x in (q, k, v, decay, torch.rand(B, T, H, generator=g))]
    state = kernels.kda_state
    o, _ = kernels.kda_chunk(*inputs, 0.3)
    with cal.planted(cal.SCAN_BF16):
        got, final = kernels.kda_chunk(*inputs, 0.3)
    assert kernels.kda_state is state
    assert 2**-12 < (got - o).abs().max() / o.abs().max() < 2**-5
    grads = torch.autograd.grad(got.sum() + final.sum(), inputs)
    assert all(torch.isfinite(x).all() for x in grads)


def test_the_precision_control_and_half_batches_are_not_correct(cell, kimi_base):
    d = manifest.driver_class(cell.config["kind"], kimi_base)(cell, SEED, [torch.device("cpu")])
    d.pool = d.tokens()
    want = d.reference()
    for got in (d.reference("fp8"), d.reference(rows=slice(0, 2))):
        assert not compare.judge(d.numbers(got, want), cell.config["limits"])[0]


def test_the_driver_refuses_two_devices(cell, kimi_base):
    d = manifest.driver_class(cell.config["kind"], kimi_base)(cell, 1, [torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="one device"):
        d.setup()


def test_the_cells_entries_resolve(bench_manifest):
    cell = manifest.find_cell(bench_manifest, CELL)
    assert cell.chips == 1 and cell.config["kind"] == "kimi_linear_train"
    assert (BENCH / "drivers" / "kimi_linear_train.py").is_file()
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "train_tokens_per_s"]
    assert [m["name"] for m in cell.per_layer] == [
        "train.mfu", "device.idle.train", "kimi.kda_ms", "kimi.kda_fwd_roofline",
        "kimi.kda_bwd_roofline"]
    config = next(c for c in bench_manifest["configs"] if c["name"] == "kimi-linear-ep16")
    assert config["reduced"] == cell.config["reduced"] == ["num_experts", "vocab_size"]
    assert (cell.config["num_experts"], cell.config["num_experts_published"]) == (16, 256)
    assert (cell.config["vocab_size"], cell.config["vocab_size_published"]) == (20480, 163840)


def test_the_configuration_holds_the_catalog_row():
    """Every number of the published config at its key, but the two cuts."""
    row = {"first_k_dense_replace": 1, "head_dim": 72, "hidden_size": 2304,
           "intermediate_size": 9216, "kv_lora_rank": 512, "moe_intermediate_size": 1024,
           "num_attention_heads": 32, "num_experts_per_token": 8, "num_hidden_layers": 27,
           "num_shared_experts": 1, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
           "rms_norm_eps": 1e-5, "routed_scaling_factor": 2.446, "v_head_dim": 128,
           "mla_use_nope": True, "moe_router_activation_func": "sigmoid", "q_lora_rank": None,
           "rope_scaling": None}
    m = json.loads((BENCH / "configs" / "kimi-linear-ep16.json").read_text())
    assert {k: m[k] for k in row} == row
    la = m["linear_attn_config"]
    assert (la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]) == (32, 128, 4)
    assert len(la["kda_layers"]) == 20 and la["full_attn_layers"] == [4, 8, 12, 16, 20, 24, 27]


def test_the_frozen_flop_count_is_the_programs():
    from tpudash_torch.models import kimi_linear as K

    cell = manifest.find_cell(json.loads((ROOT / "BENCHMARK.json").read_text()), CELL)
    m, t = cell.config, cell.traffic
    got = flops.train_flops_per_step(m, t)
    assert got == pytest.approx(K.flops_per_step(K.KimiLinearConfig()), rel=1e-12)
    assert got / 3 / flops.positions(m, t) == pytest.approx(3.4846e9, rel=1e-4)
    assert got == pytest.approx(342.51e12, rel=1e-4)
    routed = flops.uniform_routed_pairs(m, t)
    assert flops.train_flops_per_step(m, t, 2 * routed) > got
    assert flops.kda_calls_per_step(m) == {"forward": 40, "backward": 20}
    assert flops.kda_call_bound_s(m, t, False) == pytest.approx(0.4012e-3, rel=1e-3)
    assert flops.kda_call_bound_s(m, t, True) == pytest.approx(0.7223e-3, rel=1e-3)


def test_the_frozen_bytes_of_a_kda_call_are_its_inputs_and_outputs():
    """At a small size: q, k, v, the decay's and β's pre-activations in, o
    out (forward); those inputs and o's gradient in, their gradients out
    (backward), in bf16, each once, as the model's KDA layer makes them."""
    from tpudash_torch.models import kimi_linear as K

    m = {**TINY_MODEL, "linear_attn_config": TINY_MODEL["linear_attn_config"]}
    t = {"seq": 17, "batch": 3}
    cfg = K.KimiLinearConfig(d_model=64, kda_heads=2, kda_head_dim=16, gate_rank=16, batch=3, seq=17)
    B, T, H, D = 3, 16, 2, 16
    q = k = v = g = o = torch.zeros(B, T, H * D, dtype=torch.bfloat16)
    beta = torch.zeros(B, T, H, dtype=torch.bfloat16)
    inputs = [q, k, v, g, beta]
    forward = sum(x.numel() * x.element_size() for x in [*inputs, o])
    backward = sum(x.numel() * x.element_size() for x in [*inputs, o, *inputs])
    assert flops.kda_call_bytes(m, t, False) == forward
    assert flops.kda_call_bytes(m, t, True) == backward
    assert flops.positions(m, t) == B * T == cfg.batch * (cfg.seq - 1)
    # the state products: q·S, w·S and kdᵀ·v_new, 2·D·D a position and head each
    assert flops.kda_call_flops(m, t, False) == 3 * 2 * B * T * H * D * D


def test_a_run_of_the_cell_loads_no_forbidden_module(kimi_base, bench_manifest):
    code = (
        "import json, sys, time\n"
        "from pathlib import Path\n"
        "import torch\n"
        "from gpubench import manifest\n"
        "from gpubench.run import execute, forbidden_modules\n"
        "base = Path(sys.argv[1])\n"
        "cell = manifest.find_cell(json.loads(sys.argv[2]), sys.argv[3], base)\n"
        "execute(cell, 3, [torch.device('cpu')], 0.2, False, time.perf_counter(), base)\n"
        "print(json.dumps(forbidden_modules()))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(kimi_base), json.dumps(bench_manifest),
                          CELL], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
