"""The readers of the program's spans (``dgrad_roofline``,
``output_affine_roofline``, ``wgrad_roofline``, ``sgd_update_roofline``):
nothing without a trace, without the program's totals or with calls that
do not match the traced steps; the roofline arithmetic from stubbed
totals."""

from types import SimpleNamespace

import pytest

from benchmark import harness, spans, trace, work

MAN = harness.manifest()
CFG = harness.load_config(MAN["configs"][0])
BUNCHES = 7
B, F32 = CFG["bunch"], 4
LAYERS = work.layers(CFG)
# name: (span, calls a step, one step's least time at 165 TFLOP/s / 3.35 TB/s)
READERS = {
    "dgrad_roofline": ("backward.dgrad", 4, sum(
        max(2.0 * B * i * o / 165e12, F32 * (B * o + i * o + B * i) / 3.35e12)
        for i, o in LAYERS[1:])),
    "output_affine_roofline": ("forward.output", 1, max(
        2.0 * B * 4096 * 8192 / 165e12, F32 * (B * 4096 + 4096 * 8192 + 8192 + B * 8192)
        / 3.35e12)),
    "wgrad_roofline": ("backward.wgrad", 5, sum(
        max(2.0 * B * i * o / 165e12, F32 * (B * i + B * o + i * o) / 3.35e12)
        for i, o in LAYERS)),
    "sgd_update_roofline": ("step.update", 1, 12.0 * 88_104_960 / 3.35e12),
}


def _ctx(traced=True):
    return SimpleNamespace(cfg=CFG, work=work, trace=trace.Trace(0, 10 ** 9) if traced else None,
                           traced={"bunches": BUNCHES} if traced else None)


def _stub(monkeypatch, rows):
    monkeypatch.setattr(spans, "totals", lambda: rows)


@pytest.mark.parametrize("name", sorted(READERS))
def test_nothing_without_a_trace_or_totals(monkeypatch, name):
    span, per_step, _ = READERS[name]
    row = {"calls": BUNCHES * per_step, "device_s": 1.0}
    mod = harness.metric_module(name)
    _stub(monkeypatch, {span: row})
    assert mod.read(_ctx(traced=False)) is None
    for rows in (None, {}, {span: dict(row, device_s=None)}, {span: dict(row, device_s=0.0)}):
        _stub(monkeypatch, rows)
        assert mod.read(_ctx()) is None


@pytest.mark.parametrize("name", sorted(READERS))
@pytest.mark.parametrize("off", [-1, 1])
def test_nothing_when_the_calls_do_not_match(monkeypatch, name, off):
    span, per_step, _ = READERS[name]
    _stub(monkeypatch, {span: {"calls": BUNCHES * per_step + off, "device_s": 1.0}})
    assert harness.metric_module(name).read(_ctx()) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_roofline_arithmetic(monkeypatch, name):
    span, per_step, step_bound = READERS[name]
    # the spans took four times the least time
    _stub(monkeypatch, {span: {"calls": BUNCHES * per_step,
                               "device_s": 4 * BUNCHES * step_bound}})
    assert harness.metric_module(name).read(_ctx()) == pytest.approx(25.0, rel=1e-9)
    assert next(m for m in MAN["per_layer"] if m["name"] == name)["source"] == "program_span"


def test_bounds_at_the_production_widths():
    """Every step bound at the stack's widths: each GEMM bound by its
    operations, the update by its bytes."""
    assert READERS["dgrad_roofline"][2] == pytest.approx(
        2 * B * (3 * 4096 ** 2 + 4096 * 8192) / 165e12)
    assert READERS["sgd_update_roofline"][2] * 1e6 == pytest.approx(315.6, abs=0.1)
    assert sum(i * o + o for i, o in LAYERS) == 88_104_960


def test_the_ports_profiler_totals_are_read(monkeypatch):
    from nnet_asr_torch.utils.profiler import profiler

    monkeypatch.setattr(profiler, "totals", lambda: {"x": {"calls": 1}})
    assert spans.totals() == {"x": {"calls": 1}}
    monkeypatch.delattr(type(profiler), "totals")
    monkeypatch.delattr(profiler, "totals")
    assert spans.totals() is None
