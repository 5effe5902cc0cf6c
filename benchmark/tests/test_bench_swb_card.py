"""On the card, at Seide et al.'s CD-DNN shapes (429 -> 2048x7 -> 9304,
bunch 1024): each product of its step on the route its plan picks (the
profiler's ``gemm.flops.<route>`` counter says which) against float64;
the 1024 x 9304 softmax-CE (the plan's WIDE variant) against its plain
version; and traced steps' spans and counters, replayed from their graphs. Skips without a
card (decided inside each test).

Tolerance of a product: its largest error over the largest float64
element at most 2e-5. The 3xTF32 kernels' tensor-core sums truncate, about
1e-5 x K/1024 low on positive operands (PERF.md), 2e-5 at K = 2048;
cuBLAS's FFMA sums sit far below; a single TF32 pass reads near 1e-3.
"""

import pytest
import torch

from benchmark import harness, traffic
from benchmark.program import Program

B = 1024
TOL = 2e-5
CELL = "swb_cddnn.resident"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from nnet_asr_torch.utils.profiler import profiler

    was = profiler.enabled
    profiler.reset()
    profiler.enabled = True
    yield torch.device("cuda", 0), profiler
    profiler.enabled = was
    profiler.reset()


def _randn(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen, device=gen.device).mul_(scale)


def _flops(profiler) -> dict:
    return {k: c["sum"] for k, c in profiler.counters().items() if k.startswith("gemm.flops.")}


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


# name: (kind, In, Out, the route's counter)
PRODUCTS = {
    "forward 1024x429->2048": ("forward", 429, 2048, "gemm.flops.cp_wgmma"),
    "forward 1024x2048->2048": ("forward", 2048, 2048, "gemm.flops.cp_wgmma"),
    "output forward 1024x2048->9304": ("output", 2048, 9304, "gemm.flops.library"),
    "dgrad 1024x2048->2048": ("dgrad", 2048, 2048, "gemm.flops.library"),
    "dgrad 1024x2048->9304": ("dgrad", 2048, 9304, "gemm.flops.library"),
    "wgrad 1024x429->2048": ("wgrad", 429, 2048, "gemm.flops.cp_wgmma"),
    "wgrad 1024x2048->2048": ("wgrad", 2048, 2048, "gemm.flops.wgmma"),
    "wgrad 1024x2048->9304": ("wgrad", 2048, 9304, "gemm.flops.wgmma"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PRODUCTS))
def test_swb_product_on_its_route(card, name):
    from nnet_asr_torch.ops.kernels import matmul_act as MA
    from nnet_asr_torch.ops.kernels import sgd_fused as SF

    dev, profiler = card
    kind, In, Out, counter = PRODUCTS[name]
    gen = torch.Generator(device=dev).manual_seed(In * 7 + Out)
    x = _randn(gen, B, In)
    w = _randn(gen, In, Out, scale=0.05)
    b = _randn(gen, Out, scale=0.1)
    if kind == "forward":
        got = MA.matmul_act(x, w, b, "none")
        want = x.double() @ w.double() + b.double()
    elif kind == "output":
        got = MA.affine(x, w, b)
        want = x.double() @ w.double() + b.double()
    elif kind == "dgrad":
        dz = _randn(gen, B, Out, scale=1e-3)
        got = MA.dgrad(dz, w)
        want = dz.double() @ w.double().T
    else:
        e = _randn(gen, B, Out, scale=1e-3)
        p, v = w.clone(), torch.zeros_like(w)
        SF.wgrad_momentum_update(x, e, p, v, 1e-4, 0.9)
        # from a zero velocity, v is the gradient itself
        got = v
        want = x.double().T @ e.double()
    torch.cuda.synchronize()
    assert _rel(got, want) <= TOL
    assert _flops(profiler) == {counter: 2.0 * B * In * Out}


@pytest.mark.cuda
def test_swb_softmax_ce_takes_the_wide_variant(card):
    from nnet_asr_torch.ops.kernels import softmax_ce as SC
    from nnet_asr_torch.ops.kernels import softmax_plan

    dev, _ = card
    gen = torch.Generator(device=dev).manual_seed(9304)
    logits = _randn(gen, B, 9304, scale=3.0)
    labels = torch.randint(0, 9304, (B,), generator=gen, device=dev, dtype=torch.int32)
    assert softmax_plan.plan(B, 9304, logits.data_ptr()).variant == softmax_plan.WIDE
    before = SC.softmax_xent.launches
    err, xent, corr = SC.softmax_xent(logits, labels)
    assert SC.softmax_xent.launches == before + 1
    perr, pxent, pcorr = SC.softmax_xent_plain(logits, labels)
    torch.cuda.synchronize()
    # as the softmax-CE's own card tests: err within 1e-6, xent within 1e-5
    assert (err - perr).abs().max().item() <= 1e-6
    assert abs(xent.item() - pxent.item()) <= 1e-5 * abs(pxent.item())
    assert corr.item() == pcorr.item()


@pytest.mark.cuda
def test_traced_swb_steps_replay_their_spans(card):
    """Steps of the cell's Trainer under a ``torch.profiler`` session,
    replayed from the graphs that hold their spans: ``loss.softmax_ce``,
    ``forward.output`` and the seven ``backward.dgrad`` timed on the card
    at each step, and the step's products counted by route at each."""
    from torch.profiler import ProfilerActivity, profile

    dev, profiler = card
    man = harness.manifest()
    cell, entry = harness.find(man, CELL)
    cfg = harness.load_config(entry)
    mix = dict(traffic.load(cell["traffic"]), stacks=1, stack_bunches=8)
    prog = Program(cfg, mix, 2 ** 31 + 41, dev)
    feats, labels = prog.stacks[0]
    profiler.enabled = False
    prog.trainer.drain_train(feats[:2], labels[:2])         # the eager step, the captures
    torch.cuda.synchronize()
    profiler.reset()
    steps = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        prog.trainer.drain_train(feats[2:2 + steps], labels[2:2 + steps])
        torch.cuda.synchronize()
    tot = profiler.totals()
    for name in ("loss.softmax_ce", "forward.output", "step.update"):
        assert tot[name]["calls"] == steps and tot[name]["device_s"] > 0, name
        assert tot[name]["host_s"] == 0.0, name
    assert tot["backward.dgrad"]["calls"] == 7 * steps and tot["backward.dgrad"]["device_s"] > 0
    assert tot["backward.wgrad"]["calls"] == 8 * steps
    ls = list(zip(cfg["dims"][:-1], cfg["dims"][1:]))
    assert _flops(profiler) == {
        "gemm.flops.cp_wgmma": steps * 2.0 * B * (sum(i * o for i, o in ls[:-1]) + 429 * 2048),
        "gemm.flops.wgmma": steps * 2.0 * B * sum(i * o for i, o in ls[1:]),
        "gemm.flops.library": steps * 2.0 * B * (2048 * 9304 + sum(i * o for i, o in ls[1:]))}
    prog.close()
