"""The trace reduction and the per-layer readers on made-up windows: the
union of device intervals, the idle gaps named by the host's phase, and
readers that find nothing to read return nothing."""

from types import SimpleNamespace

import pytest

from benchmark import harness, trace, work


def _trace():
    t = trace.Trace(start=0, end=1000)
    t.device = [(100, 300, "void matmul_act_f32_wgmma_kernel<x>"), (250, 400, "nvjet_sgemm"),
                (600, 700, "wgrad_momentum_f32_wgmma_kernel"), (950, 1200, "Memset (Device)")]
    t.host = [(0, 1000, "bench.drain"), (400, 650, "bench.intake")]
    return t


def test_busy_union_and_gaps():
    busy, gaps = _trace().busy()
    assert busy == pytest.approx((300 + 100 + 50) * 1e-9)
    assert gaps == [(0, 100), (400, 600), (700, 950)]


def test_breakdown_names_gaps_by_phase():
    b = trace.breakdown(_trace())
    assert [g for g, _ in b["idle_gaps"]] == ["drain", "intake", "drain"]
    assert b["idle_gaps"][0][1] == pytest.approx(250e-9)
    ops = dict(b["device_ops"])
    assert ops["affine_sigmoid f32 WGMMA"] == pytest.approx(200e-9)
    assert ops["cuBLAS GEMM"] == pytest.approx(150e-9)
    assert ops["copies and fills"] == pytest.approx(250e-9)


def test_readers_find_nothing_to_read():
    cfg = harness.load_config(harness.manifest()["configs"][0])
    ctx = SimpleNamespace(cfg=cfg, work=work, trace=None, traced=None, setup_s=1.0,
                          window={"frames": 1024, "bunches": 1, "wall_s": 1.0, "failed": 0})
    for name in ("affine_sigmoid_roofline", "wgrad_momentum_update_roofline",
                 "device_idle_share", "intake_wait_share"):
        assert harness.metric_module(name).read(ctx) is None
    ctx.trace, ctx.traced = trace.Trace(0, 10), {"bunches": 1}
    assert harness.metric_module("wgrad_momentum_update_roofline").read(ctx) is None
    assert harness.metric_module("train_fps").read(ctx) == 1024.0


def test_roofline_reads_the_step_bound_over_kernel_time():
    cfg = harness.load_config(harness.manifest()["configs"][0])
    t = trace.Trace(0, 10 ** 9)
    bound = work.affine_sigmoid_bound_s(cfg)
    t.device = [(0, int(2 * bound * 1e9), "matmul_act_f32_wgmma_kernel")]
    ctx = SimpleNamespace(cfg=cfg, work=work, trace=t, traced={"bunches": 1})
    assert harness.metric_module("affine_sigmoid_roofline").read(ctx) == pytest.approx(50, rel=1e-3)
