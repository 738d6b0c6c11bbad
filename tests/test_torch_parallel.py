"""The port's inter-device probes (tpudash_torch.parallel) held against the
reference's (tpudash.parallel) on the CPU: the mesh factorisation, the
probes' detail and rate formulas, the data each collective moves, and the
ICI series TorchProbeSource emits over several CPU "devices"."""

import pytest

pytest.importorskip("torch")  # the port's own CI job installs it

import jax
import numpy as np
import torch

from tpudash import config as jconfig
from tpudash.parallel import collectives as jcoll
from tpudash.parallel import mesh as jmesh
from tpudash.sources.probe import ProbeSource
from tpudash_torch import config as tconfig
from tpudash_torch import schema as tschema
from tpudash_torch.parallel import collectives as tcoll
from tpudash_torch.parallel import mesh as tmesh
from tpudash_torch.sources.probe import TorchProbeSource
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SMALL = {"probe_matmul_size": 256, "probe_matmul_iters": 1,
         "probe_hbm_mb": 1, "probe_hbm_k1": 1, "probe_hbm_k2": 2,
         "probe_ici_mb": 1}
ICI = (tschema.ICI_TX, tschema.ICI_RX, tschema.ICI_LINK_SERIES["xp"],
       tschema.ICI_LINK_SERIES["xn"])


def _jax_mesh(n):
    return jmesh.build_mesh({"tp": n}, devices=jax.devices()[:n])


# --- mesh ----------------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 17))
def test_mesh_axes_for_matches_reference(n):
    assert tmesh.mesh_axes_for(n) == jmesh.mesh_axes_for(n)


def test_build_mesh_checks_the_axis_product_like_reference():
    with pytest.raises(ValueError, match="require 9 devices, have 8"):
        jmesh.build_mesh({"dp": 3, "tp": 3})
    with pytest.raises(ValueError, match="require 9 devices, have 8"):
        tmesh.build_mesh({"dp": 3, "tp": 3}, devices=["cpu"] * 8)
    mesh = tmesh.build_mesh(devices=["cpu"] * 8)
    assert mesh.shape == dict(jmesh.build_mesh().shape) == {"dp": 1, "tp": 8}
    assert mesh.axis_names == ("dp", "tp") and mesh.devices == (torch.device("cpu"),) * 8


def test_build_mesh_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.build_mesh()


def test_package_re_exports_the_references_names():
    import tpudash.parallel as jparallel
    import tpudash_torch.parallel as tparallel

    assert set(tparallel._LAZY) == set(jparallel._LAZY)
    for name in tparallel._LAZY:
        mod = tmesh if name in ("build_mesh", "mesh_axes_for") else tcoll
        assert getattr(tparallel, name) is getattr(mod, name)
    with pytest.raises(AttributeError, match="no attribute 'no_such_probe'"):
        tparallel.no_such_probe  # noqa: B018


# --- probe contracts: detail and rate formulas -----------------------------------

PROBES = {
    "ring": (lambda m: jcoll.ppermute_ring_bandwidth_probe(m, "tp", 2, steps=3),
             lambda d: tcoll.ppermute_ring_bandwidth_probe(d, 2, steps=3)),
    "ring reverse": (lambda m: jcoll.ppermute_ring_bandwidth_probe(m, "tp", 1, reverse=True),
                     lambda d: tcoll.ppermute_ring_bandwidth_probe(d, 1, reverse=True)),
    "all-gather": (lambda m: jcoll.all_gather_bandwidth_probe(m, "tp", 3),
                   lambda d: tcoll.all_gather_bandwidth_probe(d, 3)),
    "psum": (lambda m: jcoll.psum_latency_probe(m, "tp"),
             lambda d: tcoll.psum_latency_probe(d)),
}


@pytest.mark.parametrize("name", PROBES)
def test_probe_detail_and_rate_formula_match_reference(name, monkeypatch):
    # the same timing delta on both sides: the values then differ only if
    # the byte counts (the rate formulas) do
    for mod in (jcoll, tcoll):
        monkeypatch.setattr(mod, "_delta_time", lambda small, large: 0.25)
        monkeypatch.setattr(mod, "_timed_scalar", lambda fn, *args: 0.25)
    ref, port = PROBES[name]
    want, got = ref(_jax_mesh(4)), port(["cpu"] * 4)
    assert got.detail == want.detail
    assert got.value == want.value and got.elapsed_s == want.elapsed_s == 0.25


def test_probe_rates_are_the_stated_formulas(monkeypatch):
    monkeypatch.setattr(tcoll, "_delta_time", lambda small, large: 0.5)
    shard = 2 * 1024 * 1024  # 2 MiB of f32 per device
    ring = tcoll.ppermute_ring_bandwidth_probe(["cpu"] * 4, 2, steps=3)
    assert ring.value == shard * 2 * 3 / 0.5 / 1e9
    gather = tcoll.all_gather_bandwidth_probe(["cpu"] * 4, 2)
    assert gather.value == (4 * 3 * shard - 4 * shard) / 4 * 3 / 0.5 / 1e9


def test_probes_run_for_real_over_cpu_devices():
    devices = ["cpu"] * 4
    for r in (tcoll.ppermute_ring_bandwidth_probe(devices, 1, steps=1),
              tcoll.all_gather_bandwidth_probe(devices, 1),
              tcoll.psum_latency_probe(devices)):
        assert r.value > 0 and r.detail["devices"] == 4


# --- what each collective moves --------------------------------------------------

def _numbered_shards(n, rows=8):
    return [torch.full((rows, 1024), float(i)) for i in range(n)]


@pytest.mark.parametrize("k,reverse", [(1, False), (3, False), (1, True), (3, True)])
def test_ring_moves_shards_like_ppermute(k, reverse):
    n = 4
    shards = _numbered_shards(n)
    bufs = tuple([torch.empty_like(s) for s in shards] for _ in range(2))
    out = tcoll._ring(shards, bufs, k, reverse)
    step = -1 if reverse else 1
    assert [o[0, 0].item() for o in out] == [float((i - k * step) % n) for i in range(n)]
    assert all(bool((o == o[0, 0]).all()) for o in out)
    assert all(s[0, 0].item() == i for i, s in enumerate(shards))  # input untouched
    # the reference reads Σ ring(block)[0, :8]: shard 0 of the result
    mesh = _jax_mesh(n)
    block = jax.device_put(
        np.repeat(np.arange(n, dtype=np.float32), 8)[:, None] * np.ones((1, 1024), np.float32),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("tp", None)),
    )
    want = float(jcoll._ring_sum_fn(mesh, "tp", reverse)(block, k))
    assert out[0][0, :8].sum().item() == want


def test_all_gather_gives_every_slot_every_shard_in_order():
    n = 4
    shards = _numbered_shards(n)
    outs = [torch.full((n * 8, 1024), -1.0) for _ in range(n)]
    tcoll._all_gather(shards, outs)
    want = torch.cat(shards)
    assert all(torch.equal(o, want) for o in outs)


def test_psum_scalar_matches_reference():
    n = 4
    x = jax.device_put(np.ones((n, 128), np.float32), jax.sharding.NamedSharding(
        _jax_mesh(n), jax.sharding.PartitionSpec("tp", None)))
    want = float(jcoll._psum_fn(_jax_mesh(n), "tp")(x))
    got = tcoll._psum_sum([torch.ones((1, 128)) for _ in range(n)]).item()
    assert got == want == 8 * (1 + n * 128)


# --- the source's multi-device branch --------------------------------------------

def test_ici_series_parity_with_reference_on_an_injected_cache():
    cache = {}
    for i in range(8):  # the reference sees the conftest's 8 CPU devices
        cache[f"tflops_{i}"] = 150.0 + i
        cache[f"hbm_gbps_{i}"] = 700.0 + i
    cache.update(ici_tx=4.1e10, ici_rx=3.3e10, ici_link_xp=8.3e10, ici_link_xn=8.3e10)
    ref = ProbeSource(jconfig.Config(source="probe", extra=dict(SMALL)))
    port = TorchProbeSource(tconfig.Config(source="probe", extra=dict(SMALL)),
                            devices=["cpu"] * 8)
    ref._run_heavy_probes = lambda: dict(cache)
    port._run_heavy_probes = lambda: dict(cache)

    def table(samples):
        return {(s.metric, s.chip.chip_id): s.value for s in samples}

    want, got = table(ref.fetch()), table(port.fetch())
    assert set(got) == set(want)
    assert {m for m, _ in got} >= set(ICI)
    # utilisation and capacity divide by the H100 record, not the v5e
    # fallback (tests/test_torch_source.py holds those two)
    differ = (tschema.TENSORCORE_UTIL, tschema.HBM_TOTAL)
    assert {k: v for k, v in got.items() if k[0] not in differ} == {
        k: v for k, v in want.items() if k[0] not in differ}


def test_heavy_probes_fill_the_ici_keys_as_the_reference_does(monkeypatch):
    from tpudash_torch.ops import probes
    from tpudash_torch.ops.probes import ProbeResult

    calls = []

    def ring(devices, mb, steps=4, reverse=False):
        calls.append(("ring", len(devices), mb, reverse))
        return ProbeResult(30.0 if reverse else 20.0, 1.0, {})

    def gather(devices, mb):
        calls.append(("gather", len(devices), mb))
        return ProbeResult(15.0, 1.0, {})

    monkeypatch.setattr(tcoll, "ppermute_ring_bandwidth_probe", ring)
    monkeypatch.setattr(tcoll, "all_gather_bandwidth_probe", gather)
    monkeypatch.setattr(probes, "matmul_flops_probe", lambda *a, **k: ProbeResult(1.0, 1.0, {}))
    monkeypatch.setattr(probes, "hbm_bandwidth_probe", lambda *a, **k: ProbeResult(2.0, 1.0, {}))
    src = TorchProbeSource(tconfig.Config(extra={**SMALL, "probe_ici_mb": 5}),
                           devices=["cpu"] * 3)
    cache = src._run_heavy_probes()
    assert calls == [("ring", 3, 5, False), ("gather", 3, 5), ("ring", 3, 5, True)]
    assert cache["ici_tx"] == 20.0e9 and cache["ici_rx"] == 15.0e9
    # the reference's behaviour: both link series are (tx + rev)·1e9
    assert cache["ici_link_xp"] == cache["ici_link_xn"] == (20.0 + 30.0) * 1e9
    one = TorchProbeSource(tconfig.Config(extra=SMALL), device="cpu")._run_heavy_probes()
    assert not any(k.startswith("ici_") for k in one)


def test_device_and_devices_are_exclusive():
    with pytest.raises(ValueError, match="not both"):
        TorchProbeSource(tconfig.Config(extra=SMALL), device="cpu", devices=["cpu"])
