"""TorchProbeSource held against the reference ProbeSource on the CPU, and
the port's schema, registry and config against the reference's."""

import pytest

pytest.importorskip("torch")  # the port's own CI job installs it

import threading

import torch

from tpudash import config as jconfig
from tpudash import schema as jschema
from tpudash.sources.probe import ProbeSource
from tpudash_torch import config as tconfig
from tpudash_torch import registry as tregistry
from tpudash_torch import schema as tschema
from tpudash_torch.sources.base import SourceError
from tpudash_torch.sources.probe import TorchProbeSource
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SMALL = {"probe_matmul_size": 256, "probe_matmul_iters": 1,
         "probe_hbm_mb": 1, "probe_hbm_k1": 1, "probe_hbm_k2": 2,
         "probe_ici_mb": 1}
H100 = tregistry.GPU_GENERATIONS["h100-sxm"]


def _cfg(**extra):
    return tconfig.Config(source="probe", extra={**SMALL, **extra})


def _source(**extra):
    return TorchProbeSource(_cfg(**extra), device="cpu")


def test_source_parity_with_reference_on_an_injected_cache():
    cache = {}
    for i in range(8):  # the reference sees the conftest's 8 CPU devices
        cache[f"tflops_{i}"] = 150.0 + i
        cache[f"hbm_gbps_{i}"] = 700.0 + i
    ref = ProbeSource(jconfig.Config(source="probe", extra=dict(SMALL)))
    port = _source()
    ref._run_heavy_probes = lambda: dict(cache)
    port._run_heavy_probes = lambda: dict(cache)

    def chip0(samples):
        return {s.metric: s.value for s in samples if s.chip.chip_id == 0}

    want, got = chip0(ref.fetch()), chip0(port.fetch())
    assert set(got) == {
        tschema.TENSORCORE_UTIL, tschema.HBM_USED, tschema.HBM_TOTAL, tschema.HBM_BANDWIDTH,
    }
    for metric in (tschema.HBM_USED, tschema.HBM_BANDWIDTH):
        assert got[metric] == want[metric]
    # the two expected differences: the H100 record's peak and capacity
    # replace the v5e fallback the reference takes for an unknown device
    assert want[tschema.TENSORCORE_UTIL] == pytest.approx(min(100.0, 150.0 / 197.0 * 100.0))
    assert got[tschema.TENSORCORE_UTIL] == pytest.approx(150.0 / H100.peak_bf16_tflops * 100.0)
    assert want[tschema.HBM_TOTAL] == 16 * 1024**3
    assert got[tschema.HBM_TOTAL] == H100.hbm_gib * 1024**3


def test_samples_carry_the_reference_identity_labels():
    samples = _source().fetch()
    assert {s.chip for s in samples} == {tschema.ChipKey("local", "localhost", 0)}
    assert {s.accelerator_type for s in samples} == {"nvidia-h100-80gb"}
    utils = [s.value for s in samples if s.metric == tschema.TENSORCORE_UTIL]
    assert len(utils) == 1 and 0.0 <= utils[0] <= 100.0
    bw = [s.value for s in samples if s.metric == tschema.HBM_BANDWIDTH]
    assert len(bw) == 1 and bw[0] > 0


def test_source_rejects_bad_contrast_like_reference():
    extra = {**SMALL, "probe_hbm_k1": 5, "probe_hbm_k2": 5}
    with pytest.raises(ValueError, match="must exceed"):
        ProbeSource(jconfig.Config(source="probe", extra=extra))
    with pytest.raises(ValueError, match="must exceed"):
        TorchProbeSource(tconfig.Config(source="probe", extra=extra), device="cpu")


def test_probe_heavy_interval_caches():
    src = _source(probe_heavy_interval=3600.0)
    s1 = src.fetch()
    t_first = src._last_heavy
    s2 = src.fetch()  # within the interval → re-emits cached measurements
    assert src._last_heavy == t_first
    v1 = {s.chip.chip_id: s.value for s in s1 if s.metric == tschema.HBM_BANDWIDTH}
    v2 = {s.chip.chip_id: s.value for s in s2 if s.metric == tschema.HBM_BANDWIDTH}
    assert v1 == v2


def test_stale_cache_refreshes_off_the_scrape_path():
    src = _source(probe_heavy_interval=0.0)
    src.fetch()  # first run: blocking (warmup path)
    gate = threading.Event()
    ran = threading.Event()
    orig = src._run_heavy_probes

    def slow_heavy():
        ran.set()
        gate.wait(10)
        return orig()

    src._run_heavy_probes = slow_heavy
    before = dict(src._cache)
    samples = src.fetch()  # stale → serves old cache, spawns refresh
    assert {s.metric for s in samples}  # served without waiting
    assert dict(src._cache) == before or ran.is_set()
    gate.set()
    src.flush_refresh()
    assert src._refresh_thread is None
    assert ran.is_set()


def test_failed_probe_batch_never_leaves_partial_cache():
    src = _source(probe_heavy_interval=3600.0)

    def exploding():
        raise RuntimeError("probe blew up mid-batch")

    src._run_heavy_probes = exploding
    with pytest.raises(SourceError):
        src.fetch()
    assert src._cache == {}  # nothing half-written
    with pytest.raises(SourceError):  # still clean on retry
        src.fetch()


def test_no_gpu_and_no_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = TorchProbeSource(_cfg())
    with pytest.raises(SourceError, match="no CUDA device"):
        src.fetch()


def test_several_devices_run_the_inter_device_probes_and_emit_ici():
    src = TorchProbeSource(_cfg(), devices=["cpu"] * 2)
    samples = src.fetch()
    assert {s.chip.chip_id for s in samples} == {0, 1}
    assert set(src._cache) == {"tflops_0", "tflops_1", "hbm_gbps_0", "hbm_gbps_1",
                               "ici_tx", "ici_rx", "ici_link_xp", "ici_link_xn"}
    ici = {tschema.ICI_TX, tschema.ICI_RX, tschema.ICI_LINK_SERIES["xp"],
           tschema.ICI_LINK_SERIES["xn"]}
    for chip_id in (0, 1):
        got = {s.metric: s.value for s in samples if s.chip.chip_id == chip_id}
        assert ici <= set(got) and all(got[m] > 0 for m in ici)
        assert got[tschema.ICI_LINK_SERIES["xp"]] == got[tschema.ICI_LINK_SERIES["xn"]]


# --- schema, registry, config ----------------------------------------------------

def test_schema_names_and_help_match_reference():
    for name in ("TENSORCORE_UTIL", "HBM_USED", "HBM_TOTAL", "ICI_TX", "ICI_RX",
                 "HBM_BANDWIDTH", "ICI_LINK_DIRS", "ICI_LINK_LABELS", "ICI_LINK_SERIES"):
        assert getattr(tschema, name) == getattr(jschema, name)
    assert tschema.SERIES_HELP == {m: jschema.SERIES_HELP[m] for m in tschema.SERIES_HELP}
    key = tschema.ChipKey("s", "h", 3)
    assert key.key == jschema.ChipKey("s", "h", 3).key == "s/3"


@pytest.mark.parametrize(
    "name,record",
    [
        ("NVIDIA H100 80GB HBM3", "h100-sxm"),
        ("NVIDIA H100 PCIe", "h100-pcie"),
        ("NVIDIA A100-SXM4-40GB", None),
        ("", None),
    ],
)
def test_registry_resolves_h100_parts(name, record):
    gen = tregistry.resolve_generation_from_device_name(name)
    assert (gen.name if gen else None) == record


def test_registry_holds_datasheet_values_and_defaults_to_sxm():
    sxm, pcie = tregistry.GPU_GENERATIONS["h100-sxm"], tregistry.GPU_GENERATIONS["h100-pcie"]
    assert (sxm.peak_bf16_tflops, sxm.hbm_gbps, sxm.nominal_power_w) == (989.0, 3350.0, 700.0)
    assert (pcie.peak_bf16_tflops, pcie.hbm_gbps, pcie.nominal_power_w) == (756.0, 2000.0, 350.0)
    assert tregistry.DEFAULT_GENERATION is sxm
    assert sxm.accelerator_types == pcie.accelerator_types == ("nvidia-h100-80gb",)
    assert tregistry.resolve_generation("v5e") is None


def test_generation_hint_picks_the_record_for_an_unknown_device():
    src = TorchProbeSource(tconfig.Config(generation="h100-pcie", extra=SMALL), device="cpu")
    src._run_heavy_probes = lambda: {"tflops_0": 378.0, "hbm_gbps_0": 1.0}
    util = [s.value for s in src.fetch() if s.metric == tschema.TENSORCORE_UTIL]
    assert util == [pytest.approx(50.0)]


def test_load_config_reads_the_reference_env_names():
    env = {"TPUDASH_SOURCE": "probe", "TPUDASH_HOST": "127.0.0.1",
           "TPUDASH_EXPORTER_PORT": "9400", "TPUDASH_GENERATION": "h100-pcie",
           "TPUDASH_PORT": "19999"}
    got, want = tconfig.load_config(env), jconfig.load_config(env)
    for field in ("source", "host", "exporter_port", "generation", "port"):
        assert getattr(got, field) == getattr(want, field)
    assert (got.exporter_port, got.port) == (9400, 19999)
    default = tconfig.load_config({})
    assert (default.source, default.host, default.exporter_port) == ("prometheus", "0.0.0.0", 9100)
    assert default.port == jconfig.Config().port == 8050
