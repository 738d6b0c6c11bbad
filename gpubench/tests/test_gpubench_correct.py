"""What decides ``correct``, at a size the CPU runs: sound runs of the
shrunk cells are correct against their configuration's limits; each fault
that a cell can have, planted under the timed path of an otherwise whole
run, and each cell's control make it false."""

import pytest
import torch

from gpubench import calibrate, compare, manifest


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["probe-defaults.1gpu", "workload-defaults.tp4"])
def test_a_sound_run_is_correct(cpu_run, cell):
    r = cpu_run(cell)
    assert r["correct"], r["checks"]
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "counts", "checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2


def _probe_fault(monkeypatch, kind):
    from tpudash_torch.ops import probes

    if kind == "answer altered":
        loop = probes._hbm_read_loop
        monkeypatch.setattr(probes, "_hbm_read_loop", lambda x, b, r: loop(x, b, r) + 1.0)
        return
    orig = probes.hbm_read_pass

    def broken(x, prev, block_rows=128, scratch=None):
        if kind == "state unchanged":
            return prev.clone()
        return orig(x[: x.shape[0] // 2], prev, block_rows, None) * 2 - prev  # half the batch

    monkeypatch.setattr(probes, "hbm_read_pass", broken)


@pytest.mark.parametrize("kind", ["state unchanged", "half batch", "answer altered"])
def test_a_probe_fault_is_not_correct(cpu_run, monkeypatch, kind):
    _probe_fault(monkeypatch, kind)
    assert not cpu_run("probe-defaults.1gpu")["correct"]


def _train_fault(monkeypatch, kind):
    from tpudash_torch.models import workload as W

    orig = W.make_sharded_train_step

    def broken(mesh, cfg):
        step, shard_inputs = orig(mesh, cfg)
        plan = W.shard_plan(mesh, cfg)

        def faulty(state, opt, tokens):
            if kind == "state unchanged":
                with torch.no_grad():
                    return W.sharded_loss_fn(state, tokens, plan)
            if kind == "half batch":
                return step(state, opt, tokens[: tokens.shape[0] // 2])
            if kind == "replica altered":  # the last tp column's final norm moved apart
                loss = step(state, opt, tokens)
                with torch.no_grad():
                    state["ln_f"][0][-1].add_(1e-3)
                return loss
            return step(state, opt, tokens) * 1.01  # answer altered

        return faulty, shard_inputs

    monkeypatch.setattr(W, "make_sharded_train_step", broken)


@pytest.mark.parametrize("kind", ["state unchanged", "half batch", "exchange left out",
                                  "answer altered", "replica altered"])
def test_a_train_fault_is_not_correct(cpu_run, monkeypatch, kind):
    if kind == "exchange left out":
        with calibrate.exchange_left_out():
            r = cpu_run("workload-defaults.tp4")
    else:
        _train_fault(monkeypatch, kind)
        r = cpu_run("workload-defaults.tp4")
    assert not r["correct"], r["checks"]


def test_the_train_driver_refuses_one_device(tiny_base, bench_manifest):
    cell = manifest.find_cell(bench_manifest, "workload-defaults.tp4", tiny_base)
    d = manifest.driver_class("train", tiny_base)(cell, 5, [torch.device("cpu")])
    with pytest.raises(ValueError, match="2 devices"):
        d.setup()


def test_the_train_control_is_not_correct(tiny_base, bench_manifest):
    cell = manifest.find_cell(bench_manifest, "workload-defaults.tp4", tiny_base)
    d = manifest.driver_class("train", tiny_base)(cell, 2**31 + 11, [torch.device("cpu")] * 4)
    d.pool = d.tokens()
    numbers = d.numbers(d.reference("fp8"), d.reference())
    # the reference holds one copy of each parameter: no replicas to compare
    limits = {k: v for k, v in cell.config["limits"].items() if k != "replica_gap"}
    assert not compare.judge(numbers, limits)[0], numbers


def test_the_probe_control_is_not_correct(tiny_base, cells_manifest):
    cell = manifest.find_cell(cells_manifest, "probe-defaults.1gpu", tiny_base)
    d = manifest.driver_class("probe", tiny_base)(cell, 2**31 + 11, [torch.device("cpu")])
    d.setup()
    d.free()
    limits = cell.config["limits"]
    sound, control = d.seeded(), d.seeded(control=True)
    assert all(v <= limits[k] for k, v in sound.items()), sound
    assert any(v > limits[k] for k, v in control.items()), control


def test_a_batch_that_serves_a_rate_above_the_peak_is_not_correct(cpu_run, monkeypatch):
    from tpudash_torch.sources.probe import TorchProbeSource

    run = TorchProbeSource._run_heavy_probes

    def too_fast(self):
        fresh = run(self)
        fresh["tflops_0"] = 989.0 * 1.06
        return fresh

    monkeypatch.setattr(TorchProbeSource, "_run_heavy_probes", too_fast)
    r = cpu_run("probe-defaults.1gpu")
    assert not r["correct"] and r["failed"] == 0
    assert r["checks"]["rate_share_max"] == {"value": 1.06, "limit": 1.05}
