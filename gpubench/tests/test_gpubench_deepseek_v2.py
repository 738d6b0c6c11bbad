"""The DeepSeek-V2-Lite cell at a size the CPU runs: its driver runs the
cell end to end, each planted fault and the precision control make
``correct`` false, its files import no JAX, and its entries in
``BENCHMARK.json`` resolve.

The shrunk configuration keeps the published structure (MLA with YaRN, one
dense layer then MoE, a router over 16 experts with 8 held, top-3, 2
shared experts) and the cell's init at d 64, 3 layers, batch 8 × seq 64.
Its limits are set as the cell's are (``calibrate_deepseek_v2.readings``
on the CPU): sound runs of 8 seeds read at most loss 1e-5, gradient norms
5.27e-3, change 1.90e-2; the fp8 control (2 seeds) at least loss 6e-5,
gradient 4.05e-2 (its change, 1.99e-2, does not tell); the faults (2
seeds) at least: rope's interleave dropped gradient 7.9e-2,
``norm_topk_prob`` on gradient 4.0, shared experts left out gradient and
change 1.0, half batches gradient 0.33.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from gpubench import calibrate_deepseek_v2 as cal
from gpubench import compare, manifest
from gpubench import flops_deepseek_v2 as flops
from gpubench.run import execute

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

CELL = "deepseek-v2-lite-ep8.1gpu"
TINY_MODEL = {"hidden_size": 64, "num_attention_heads": 4, "qk_nope_head_dim": 16,
              "qk_rope_head_dim": 8, "v_head_dim": 16, "kv_lora_rank": 32,
              "n_routed_experts_published": 16, "n_routed_experts": 8, "num_experts_per_tok": 3,
              "moe_intermediate_size": 24, "num_hidden_layers": 3, "intermediate_size": 96,
              "vocab_size": 128,
              "limits": {"loss_gap": 3e-5, "grad_norm_gap": 0.02, "change_norm_gap": 0.05}}
TINY_TRAFFIC = {"seq": 64, "batch": 8}
SEED = 2**31 + 7


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dsv2_base(tmp_path_factory):
    base = tmp_path_factory.mktemp("gpubench_dsv2")
    for d in ("configs", "traffic", "drivers", "metrics"):
        shutil.copytree(BENCH / d, base / d)
    for path, change in ((base / "configs" / "deepseek-v2-lite-ep8.json", TINY_MODEL),
                         (base / "traffic" / "train-zipf-4k.json", TINY_TRAFFIC)):
        path.write_text(json.dumps({**json.loads(path.read_text()), **change}))
    return base


@pytest.fixture(scope="module")
def cell(dsv2_base, bench_manifest):
    return manifest.find_cell(bench_manifest, CELL, dsv2_base)


def _run(cell, base, seed=SEED, trace=False) -> dict:
    return execute(cell, seed, [torch.device("cpu")], 0.3, trace, time.perf_counter(), base)


@pytest.mark.parametrize("trace", [False, True], ids=["end_to_end", "per_layer"])
def test_a_sound_run_of_the_cell_is_correct(cell, dsv2_base, trace):
    r = _run(cell, dsv2_base, trace=trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r["checks"]) == ["loss_gap", "grad_norm_gap", "change_norm_gap"]
    counts = r["counts"]
    assert counts["counted_steps"] == counts["steps"] > 0 and len(counts["expert_tokens"]) == 8
    if trace:  # the CPU run has no device trace: the counter's metric alone
        assert set(r["metrics"]) == {"dsv2.expert_load_max_over_mean"}
        assert r["metrics"]["dsv2.expert_load_max_over_mean"]["value"] >= 1.0
    else:
        assert set(r["metrics"]) == {"setup_s", "train_tokens_per_s"}


@pytest.mark.parametrize("fault", cal.FAULTS)
def test_a_planted_fault_is_not_correct(cell, dsv2_base, fault):
    with cal.planted(fault):
        r = _run(cell, dsv2_base)
    assert not r["correct"], r["checks"]


def test_the_precision_control_and_half_batches_are_not_correct(cell, dsv2_base):
    d = manifest.driver_class(cell.config["kind"], dsv2_base)(cell, SEED, [torch.device("cpu")])
    d.pool = d.tokens()
    want = d.reference()
    for got in (d.reference("fp8"), d.reference(rows=slice(0, 4))):
        assert not compare.judge(d.numbers(got, want), cell.config["limits"])[0]


def test_the_driver_refuses_two_devices(cell, dsv2_base):
    d = manifest.driver_class(cell.config["kind"], dsv2_base)(cell, 1, [torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="one device"):
        d.setup()


def test_the_zipf_pool_is_seeded_and_skewed():
    path = BENCH / "drivers" / "deepseek_v2_train.py"
    spec = importlib.util.spec_from_file_location("dsv2_driver", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    a = mod.zipf_pool(2, 8, 512, 12800, 1.1, SEED, "cpu")
    assert torch.equal(a, mod.zipf_pool(2, 8, 512, 12800, 1.1, SEED, "cpu"))
    assert a.shape == (2, 8, 512) and a.min() >= 0 and a.max() < 12800
    top = torch.bincount(a.flatten()).max().item() / a.numel()
    assert 0.10 < top < 0.20  # the most frequent id: 1/H(12800, 1.1) ≈ 15 %


def test_the_cells_entries_resolve(bench_manifest):
    names = {w["name"] for w in bench_manifest["workloads"]}
    for m in bench_manifest["end_to_end"] + bench_manifest["per_layer"]:
        assert set(m.get("workloads", ())) <= names, m["name"]
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    cell = manifest.find_cell(bench_manifest, CELL)
    assert cell.chips == 1 and cell.config["kind"] == "deepseek_v2_train"
    assert (BENCH / "drivers" / "deepseek_v2_train.py").is_file()
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "train_tokens_per_s"]
    assert [m["name"] for m in cell.per_layer] == [
        "train.mfu", "device.idle.train", "dsv2.expert_load_max_over_mean", "dsv2.attention_ms"]
    config = next(c for c in bench_manifest["configs"] if c["name"] == "deepseek-v2-lite-ep8")
    assert config["reduced"] == cell.config["reduced"] == ["n_routed_experts", "vocab_size"]


def test_the_frozen_flop_count_is_the_programs():
    from tpudash_torch.models import deepseek_v2 as D

    cell = manifest.find_cell(json.loads((ROOT / "BENCHMARK.json").read_text()), CELL)
    m, t = cell.config, cell.traffic
    got = flops.train_flops_per_step(m, t)
    assert got == pytest.approx(D.flops_per_step(D.DeepseekV2Config()), rel=1e-12)
    assert got / 3 / flops.positions(m, t) == pytest.approx(2.7402e9, rel=1e-4)
    assert got == pytest.approx(269.31e12, rel=1e-4)
    routed = flops.uniform_routed_pairs(m, t)
    assert flops.train_flops_per_step(m, t, 2 * routed) > got


def test_a_run_of_the_cell_loads_no_forbidden_module(dsv2_base, bench_manifest):
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
    out = subprocess.run([sys.executable, "-c", code, str(dsv2_base), json.dumps(bench_manifest),
                          CELL], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
