"""The cell of Seide et al.'s Switchboard CD-DNN (``swb_cddnn.resident``)
and the readers added with it, on the CPU: the yardstick's counts at the
published widths, each reader on planted span and counter totals (nothing
where the program keeps none), and ``library_gemm_share`` at the share the
kernels' plans give each cell."""

from types import SimpleNamespace

import pytest

from benchmark import harness, spans, trace, work

MAN = harness.manifest()
CONFIGS = {e["name"]: harness.load_config(e) for e in MAN["configs"]}
SWB = CONFIGS["swb_cddnn"]
BUNCHES = 5
ALIGNED = 1 << 20


def _ctx(cfg, traced=True, window=None):
    return SimpleNamespace(cfg=cfg, work=work, trace=trace.Trace(0, 10 ** 9) if traced else None,
                           traced={"bunches": BUNCHES} if traced else None,
                           window=window, setup_s=1.0)


def test_counts_at_the_published_widths():
    c = work.counts(SWB)
    # 429*2048 + 6*2048^2 + 2048*9304 weights and 7*2048 + 9304 biases
    assert c["params"] == 45_122_648
    # forward and weight gradient 2·ΣIn·Out each, input gradients of layers 2-8
    assert c["flops_per_frame"] == 268_836_864
    assert c["affine_sigmoid_bound_us"] == pytest.approx(323.27, abs=0.01)
    assert c["wgrad_momentum_bound_us"] == pytest.approx(559.77, abs=0.01)
    dgrad = harness.metric_module("dgrad_roofline").bound_s(SWB, work)
    assert dgrad * 1e6 == pytest.approx(548.87, abs=0.01)
    softmax = harness.metric_module("softmax_ce_roofline").bound_s(SWB, work)
    # 1024 x 9304 logits read and err written, 1024 labels read, at 3.35 TB/s
    assert softmax * 1e6 == pytest.approx(22.75, abs=0.01)
    assert softmax == (8 * 1024 * 9304 + 4 * 1024) / 3.35e12


def test_the_cell_and_its_metrics_are_declared():
    cell, entry = harness.find(MAN, "swb_cddnn.resident")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("swb_cddnn", "resident", 1)
    assert entry["reduced"] == [] and SWB["dims"] == [429] + [2048] * 7 + [9304]
    assert (SWB["bunch"], SWB["momentum"], SWB["compute"]) == (1024, 0.9, "f32")
    names = {m["name"] for m in harness.cell_metrics(MAN, "swb_cddnn.resident", True)}
    swb_only = {"swb_train_mfu", "swb_device_idle_share", "swb_dgrad_roofline",
                "swb_affine_sigmoid_roofline", "swb_wgrad_momentum_update_roofline",
                "swb_output_affine_roofline"}
    assert names == swb_only | {"softmax_ce_roofline", "library_gemm_share"}
    for cell in ("prod_tnetcu.resident", "prod_tnet_sgd.resident"):
        names = {m["name"] for m in harness.cell_metrics(MAN, cell, True)}
        assert {"softmax_ce_roofline", "library_gemm_share"} <= names
        assert not names & swb_only


# name: (span, calls a step, one step's least time)
SPAN_READERS = {
    "swb_output_affine_roofline": ("forward.output", 1,
                                   harness.metric_module("output_affine_roofline").bound_s(
                                       SWB, work)),
    "softmax_ce_roofline": ("loss.softmax_ce", 1, (8 * 1024 * 9304 + 4 * 1024) / 3.35e12),
    "swb_dgrad_roofline": ("backward.dgrad", 7,
                           harness.metric_module("dgrad_roofline").bound_s(SWB, work)),
}


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_span_readers_on_planted_totals(monkeypatch, name):
    span, per_step, step_bound = SPAN_READERS[name]
    mod = harness.metric_module(name)
    row = {"calls": BUNCHES * per_step, "device_s": 4 * BUNCHES * step_bound}
    monkeypatch.setattr(spans, "totals", lambda: {span: row})
    # the spans took four times the least time
    assert mod.read(_ctx(SWB)) == pytest.approx(25.0, rel=1e-9)
    assert mod.read(_ctx(SWB, traced=False)) is None
    for rows in (None, {}, {span: dict(row, device_s=None)},
                 {span: dict(row, calls=row["calls"] + 1)}):
        monkeypatch.setattr(spans, "totals", lambda: rows)
        assert mod.read(_ctx(SWB)) is None


# name: (kernel name in the trace, one step's least time)
KERNEL_READERS = {
    "swb_affine_sigmoid_roofline": ("matmul_act_f32_cp_wgmma", work.affine_sigmoid_bound_s(SWB)),
    "swb_wgrad_momentum_update_roofline": ("wgrad_momentum_update_f32_wgmma",
                                           work.wgrad_momentum_bound_s(SWB)),
}


@pytest.mark.parametrize("name", sorted(KERNEL_READERS))
def test_kernel_readers_on_planted_traces(name):
    kernel, step_bound = KERNEL_READERS[name]
    mod = harness.metric_module(name)
    ctx = _ctx(SWB)
    # the named kernels took twice the least time; another kernel is not counted
    ns = round(2 * BUNCHES * step_bound * 1e9)
    ctx.trace.device = [(0, ns // 2, kernel), (ns // 2, ns, kernel + "_prepass"),
                        (ns, 2 * ns, "sm90_xmma_gemm_f32f32")]
    assert mod.read(ctx) == pytest.approx(50.0, rel=1e-6)
    assert mod.read(ctx) == harness.metric_module(name[len("swb_"):]).read(ctx)
    assert mod.read(_ctx(SWB, traced=False)) is None
    ctx.trace.device = [(0, ns, "sm90_xmma_gemm_f32f32")]
    assert mod.read(ctx) is None


def test_step_and_device_readers_read_the_accepted_ones():
    window = {"frames": 200_000, "bunches": 195, "wall_s": 1.0, "failed": 0}
    ctx = _ctx(SWB, window=window)
    ctx.trace.device = [(0, 10 ** 8, "k")]
    mfu = harness.metric_module("swb_train_mfu").read(ctx)
    assert mfu == harness.metric_module("train_mfu").read(ctx)
    assert mfu == pytest.approx(100 * 200_000 * 268_836_864 / 165e12)
    idle = harness.metric_module("swb_device_idle_share").read(ctx)
    assert idle == pytest.approx(90.0)
    assert harness.metric_module("swb_device_idle_share").read(_ctx(SWB, traced=False)) is None


def _step_flops(cfg: dict) -> dict:
    """The counters one step adds, route by route, as the kernels' plans
    route its products (16-byte aligned operands): each hidden forward
    by ``tile_plan.plan``, the output forward by the library, each input
    gradient after the first layer's by ``dgrad_plan``, each weight
    gradient by ``plan`` with momentum and by the library without."""
    from nnet_asr_torch.ops.kernels import tile_plan as tp

    B, ls, out = cfg["bunch"], work.layers(cfg), {}

    def add(route, n):
        name = tp.LIBRARY_FLOPS if route is None else tp.ROUTE_FLOPS[route]
        out[name] = out.get(name, 0) + n

    for k, (i, o) in enumerate(ls):
        flops = 2 * B * i * o
        last = k == len(ls) - 1
        add(None if last else tp.plan(B, o, i, i, o, ALIGNED, ALIGNED,
                                      out_ptrs=(ALIGNED,)).route, flops)
        if k:
            p = tp.dgrad_plan(B, i, o, ALIGNED, ALIGNED, out_ptrs=(ALIGNED,))
            add(None if p is None else p.route, flops)
        add(tp.plan(i, o, B, i, o, ALIGNED, ALIGNED, wgrad=True,
                    out_ptrs=(ALIGNED, ALIGNED)).route if cfg["momentum"] else None, flops)
    return out


@pytest.mark.parametrize("config,share", [("swb_cddnn", 47.07), ("prod_tnetcu", 12.90),
                                          ("prod_tnet_sgd", 46.77)])
def test_library_gemm_share_at_the_plans_routes(monkeypatch, config, share):
    cfg = CONFIGS[config]
    step = _step_flops(cfg)
    assert sum(step.values()) == cfg["bunch"] * work.step_flops_per_frame(cfg)
    planted = {k: {"adds": 1, "sum": BUNCHES * v} for k, v in step.items()}
    planted["step.frames"] = {"adds": BUNCHES, "sum": BUNCHES * cfg["bunch"]}
    mod = harness.metric_module("library_gemm_share")
    monkeypatch.setattr(mod, "counters", lambda: planted)
    assert mod.read(_ctx(cfg)) == pytest.approx(share, abs=0.005)
    assert mod.read(_ctx(cfg, traced=False)) is None


def test_swb_routes_by_counter():
    """Seide et al.'s step: its 2048-wide forwards and first weight
    gradient on CP_WGMMA, the other weight gradients on WGMMA, the
    output forward and every input gradient on the library."""
    B = 1024
    step = _step_flops(SWB)
    assert step == {
        "gemm.flops.cp_wgmma": 2 * B * (429 * 2048 + 6 * 2048 ** 2) + 2 * B * 429 * 2048,
        "gemm.flops.wgmma": 2 * B * (6 * 2048 ** 2 + 2048 * 9304),
        "gemm.flops.library": 2 * B * 2048 * 9304 + 2 * B * (6 * 2048 ** 2 + 2048 * 9304)}
    assert step["gemm.flops.library"] == B * 126_550_016


def test_library_gemm_share_finds_nothing_without_counters(monkeypatch):
    mod = harness.metric_module("library_gemm_share")
    for planted in (None, {}, {"step.frames": {"adds": 1, "sum": 1024}},
                    {"gemm.flops.library": {"adds": 1, "sum": 0}}):
        monkeypatch.setattr(mod, "counters", lambda: planted)
        assert mod.read(_ctx(SWB)) is None
    # a program whose profiler keeps no counters
    from nnet_asr_torch.utils.profiler import profiler

    monkeypatch.undo()
    monkeypatch.delattr(type(profiler), "counters")
    assert mod.counters() is None and mod.read(_ctx(SWB)) is None
