"""The port's anomaly scorer (tpudash_torch.anomaly.baselines.make_scorer)
held against the reference's numpy and jax scorers on the CPU, and wired
into the reference's AnomalyEngine."""

import pytest

pytest.importorskip("torch")  # the port's own CI job installs it

import numpy as np
import pandas as pd
import torch

from tpudash import schema
from tpudash.anomaly.baselines import MIN_COUNT
from tpudash.anomaly.baselines import make_scorer as ref_make_scorer
from tpudash.anomaly.detect import AnomalyEngine
from tpudash.config import Config
from tpudash.normalize import dense_block
from tpudash_torch.anomaly import baselines
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

#: the reference test's own bound (tests/test_anomaly.py::test_scorer_jax_parity_with_numpy)
TOL = dict(rtol=1e-6, atol=1e-6, equal_nan=True)


def _random_score_inputs(k=64, c=8, seed=7):
    # tests/test_anomaly.py's recipe
    rng = np.random.default_rng(seed)
    x = rng.normal(50.0, 20.0, (k, c))
    loc = rng.normal(50.0, 5.0, (k, c))
    scale = np.abs(rng.normal(3.0, 1.0, (k, c))) + 0.1
    x[0, 0] = np.nan
    loc[1, 1] = np.nan  # cold cell → NaN score
    return x, loc, scale


@pytest.mark.parametrize("k", [256, 250, 8])
def test_scorer_matches_numpy(k):
    score, backend = baselines.make_scorer(device="cpu")
    assert backend == "torch"
    x, loc, scale = _random_score_inputs(k=k, c=12)
    got = score(x, loc, scale)
    want = ref_make_scorer(False)[0](x, loc, scale)
    assert got.dtype == np.float32 and got.shape == (k, 12)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.isnan(got[0, 0]) and np.isnan(got[1, 1])


@pytest.mark.parametrize("k", [256, 250])
def test_scorer_matches_the_jax_scorer_on_its_8_device_mesh(k):
    jax_score, backend = ref_make_scorer(True)
    assert backend == "jax"  # the conftest's 8-device CPU platform
    score, _ = baselines.make_scorer(device="cpu")
    x, loc, scale = _random_score_inputs(k=k, c=12)
    np.testing.assert_allclose(score(x, loc, scale), jax_score(x, loc, scale), **TOL)


def test_zero_scale_gives_numpys_inf_and_nan():
    score, _ = baselines.make_scorer(device="cpu")
    x, loc, scale = _random_score_inputs(k=256, c=12)
    scale[:, 3] = 0.0
    x[5, 3] = loc[5, 3]  # 0 / 0
    got = score(x, loc, scale)
    want = ref_make_scorer(False)[0](x, loc, scale)
    assert np.isinf(got[:, 3]).sum() == np.isinf(want[:, 3]).sum() > 0
    assert np.isnan(got[5, 3])
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    np.testing.assert_allclose(got, want, **TOL)


def test_no_gpu_raises_and_never_falls_back_to_numpy(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        baselines.make_scorer()


def test_engine_wired_to_the_port_scorer_reports_the_numpy_engines_findings():
    # tests/test_anomaly.py::test_engine_baseline_deviation_fires_on_self_drift's
    # ticks through two engines, one scoring with numpy and one with the port
    cfg = Config(anomaly=True, anomaly_score_threshold=4.0)
    ref, port = AnomalyEngine.from_config(cfg), AnomalyEngine.from_config(cfg)
    assert ref.backend == "numpy"
    port._scorer, port.backend = baselines.make_scorer(device="cpu")
    keys = [f"s/{i}" for i in range(8)]

    def mkdf(vals):
        df = pd.DataFrame({schema.TENSORCORE_UTIL: dict(zip(keys, vals))})
        df["slice_id"] = "s"
        df["chip_id"] = range(len(keys))
        df["host"] = ""
        return df

    base = np.array([90.0, 89.0, 91.0, 90.5, 89.5, 90.0, 91.0, 89.0])
    sick = base.copy()
    sick[3] = 40.0
    ticks = [base + 0.1 * k for _ in range(MIN_COUNT + 1) for k in range(3)] + [sick] * 3
    for i, vals in enumerate(ticks):
        df = mkdf(vals)
        got = port.observe(20.0 * i, df, block=dense_block(df), stragglers=[])
        want = ref.observe(20.0 * i, df, block=dense_block(df), stragglers=[])
        assert got == want
        assert port.alert_entries == ref.alert_entries
    fired = [e for e in port.alert_entries if e["state"] == "firing"]
    assert any(e["chip"] == "s/3" and e["kind"] == "baseline" for e in fired)
