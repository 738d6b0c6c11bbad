"""The window's rate and tail over all of its items, and the trace's
roofline, idle and peer-copy arithmetic on a synthetic event list."""

from types import SimpleNamespace

import pytest

from gpubench import manifest, peaks, stats, trace
from gpubench.run import Context, Window


def _ctx(items, counts=None, summary=None, devices=(0,)):
    return Context(devices=[SimpleNamespace(index=i) for i in devices], setup_s=12.5,
                   window=Window(items[0][0], items[-1][1], items), counts=counts or {},
                   trace=summary)


def _read(name, ctx):
    return manifest.metric_reader(name)(ctx)


def test_rate_and_tail_take_every_item():
    # 100 items of 10 ms and 10 of 100 ms, back to back
    durations = [0.01] * 100 + [0.1] * 10
    items, t = [], 0.0
    for d in durations:
        items.append((t, t + d, 8192, True))
        t += d
    ctx = _ctx(items)
    assert _read("probe_batch_ms", ctx) == pytest.approx(2000.0 / 110)
    assert _read("train_tokens_per_s", ctx) == pytest.approx(110 * 8192 / 2.0)
    # rank 0.95 * 109 = 103.55 of the sorted durations: all 100 ms from rank 100
    assert _read("probe_batch_p95_ms", ctx) == pytest.approx(100.0)
    assert _read("setup_s", ctx) == 12.5


def test_percentile():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def _events():
    """Two GPUs over a 10 ms window: GPU 0 runs a read pass (two kernels)
    and a GEMM; GPU 1 a peer copy overlapping a kernel on another stream."""
    us = 1000
    window = trace.Span(trace.WINDOW, 0, 10_000 * us)
    device = [
        (0, "(anonymous namespace)::column_partials(float4 const*)", 1_000 * us, 1_090 * us),
        (0, "(anonymous namespace)::finish_columns(float const*)", 1_090 * us, 1_092 * us),
        (0, "sm90_xmma_gemm_bf16bf16_bf16f32", 2_000 * us, 2_020 * us),
        (1, "Memcpy PtoP (Device -> Device)", 500 * us, 4_500 * us),
        (1, "elementwise_kernel", 4_000 * us, 6_000 * us),
        (1, "clipped_kernel", 9_990 * us, 10_500 * us),  # runs past the window's end
    ]
    host = [trace.Span("aten::item", 1_092 * us, 2_000 * us),
            trace.Span("cudaStreamSynchronize", 1_100 * us, 1_990 * us)]
    return trace.reduce(device, host, window)


def test_trace_reduction():
    s = _events()
    assert s.window_s == pytest.approx(0.010)
    assert s.busy_s[0] == pytest.approx(0.000112)
    assert s.busy_s[1] == pytest.approx(0.0055 + 0.00001)  # the overlap counts once
    assert s.seconds(r"Memcpy PtoP") == pytest.approx(0.004)
    assert s.count(r"column_partials|finish_columns") == 2
    assert s.seconds("clipped") == pytest.approx(0.00001)
    # the gap between the read pass and the GEMM: the innermost host op
    assert s.idle_by_host["cudaStreamSynchronize"] == pytest.approx(0.000908 / 2)
    b = s.breakdown()
    assert b["device_ops"][0][0] == "Memcpy PtoP (Device -> Device)" and len(b["idle_gaps"]) <= 10


def test_roofline_idle_and_ptop_readers():
    s = _events()
    bytes_ = peaks.read_pass_bytes(8192, 8192)
    assert bytes_ == 268_500_992
    ctx = _ctx([(0.0, 0.01, 1, True)], {"read_passes": 1, "read_pass_bytes": bytes_,
                                       "gemms": 1, "gemm_flops": peaks.gemm_flops(2048, 2048, 2048),
                                       "steps": 2, "gpus": 2,
                                       "flops_per_step": 1e9}, s, devices=(0, 1))
    assert _read("hbm_read_roofline", ctx) == pytest.approx(100 * bytes_ / 3.35e12 / 92e-6)
    # a trace that lost a launch, or holds more than the window issued: no reading
    for passes in (2, 0.5):
        off = _ctx([(0.0, 0.01, 1, True)], {**ctx.counts, "read_passes": passes, "gemms": passes}, s)
        assert _read("hbm_read_roofline", off) is None and _read("probe_gemm_roofline", off) is None
    assert _read("probe_gemm_roofline", ctx) == pytest.approx(100 * 2 * 2048**3 / 989e12 / 20e-6)
    assert _read("collectives.ptop_ms", ctx) == pytest.approx(2.0)
    idle = 100 * (1 - (0.000112 + 0.00551) / 2 / 0.010)
    assert _read("device.idle.train", ctx) == pytest.approx(idle)
    assert _read("device.idle.probe", ctx) == pytest.approx(idle)
    assert _read("train.mfu", ctx) == pytest.approx(100 * 2e9 / 0.01 / (989e12 * 2))
    # nothing to read: the reader returns nothing, never 0
    empty = _ctx([(0.0, 0.01, 1, True)], {})
    for name in ("hbm_read_roofline", "probe_gemm_roofline", "device.idle.probe", "train.mfu",
                 "collectives.ptop_ms"):
        assert _read(name, empty) is None


def test_flops_per_step_is_the_workload_count():
    m = dict(vocab=2048, d_model=1024, n_heads=16, n_layers=8, d_ff=4096, seq=512, batch=16)
    assert peaks.train_flops_per_step(**m) / 1e12 == pytest.approx(5.4632, abs=5e-5)
