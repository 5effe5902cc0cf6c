"""The Trainer's train step replayed from a CUDA graph (``_graph_step``)
against the same step run eagerly, on the card: the same weights, velocity
and stats bit for bit after several bunches, the kernels the eager steps
launch (the wrappers' launch counters less the launches captures recorded,
plus those replays made), a new capture when the learning rate changes or
the state tensors are replaced, under a ``torch.profiler`` session the
graphs that hold the step's spans, and no graph where the step is not the
fused softmax-CE one. The eager side runs under ``-T 4`` (the profiler's
spans on), where the step takes its spans and no graph. Skips without a
card (decided inside each test)."""

import contextlib


import numpy as np
import pytest
import torch

from nnet_asr_torch.models.components import BiasedLinearity, Sigmoid, Softmax
from nnet_asr_torch.models.network import Network
from nnet_asr_torch.ops.kernels import matmul_act as MA
from nnet_asr_torch.ops.kernels import sgd_fused as SF
from nnet_asr_torch.ops.kernels import softmax_ce as SC
from nnet_asr_torch.train.sgd import SgdConfig
from nnet_asr_torch.train.trainer import GRAPH_LAUNCHES, Trainer, TrainerConfig
from nnet_asr_torch.utils.profiler import profiler

torch.set_num_threads(2)

# the production stack's shape at a quarter of its widths: every f32 route
# of the step (the plans take CP_WGMMA at these widths) and the fused wgrad
DIMS = [256, 1024, 1024, 2048]
B, NB = 1024, 6
COUNTERS = ((MA.matmul_act, "launches"), (MA.dgrad, "launches"),
            (SF.wgrad_momentum_update, "launches"), (SC.softmax_xent, "launches"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    was = profiler.enabled
    yield torch.device("cuda", 0)
    profiler.enabled = was
    profiler.reset()


def _trainer(dev, momentum: float, **kw) -> Trainer:
    rng = np.random.default_rng(31)
    layers = []
    for i, (n_in, n_out) in enumerate(zip(DIMS[:-1], DIMS[1:])):
        layers.append(BiasedLinearity(n_in, n_out))
        layers.append(Softmax(n_out, n_out) if i == len(DIMS) - 2 else Sigmoid(n_out, n_out))
    params = []
    for spec in layers:
        if isinstance(spec, BiasedLinearity):
            params.append({"weight": (0.05 * rng.standard_normal(spec.weight.shape)).astype(
                np.float32), "bias": np.zeros(spec.bias.shape, np.float32)})
        else:
            params.append({})
    net = Network(layers).from_numpy_params(params)
    cfg = TrainerConfig(bunchsize=B, cachesize=B * NB,
                        sgd=SgdConfig(learning_rate=0.01, momentum=momentum), **kw)
    return Trainer(net, cfg, device=dev)


def _stack(dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    return (torch.randn((NB, B, DIMS[0]), generator=gen, device=dev),
            torch.randint(0, DIMS[-1], (NB, B), generator=gen, device=dev, dtype=torch.int32))


def _launched():
    """The wrappers' kernels that ran: their counters, less what captures
    recorded, plus what replays launched."""
    return [getattr(f, k) - GRAPH_LAUNCHES["captured"][f"{f.__name__}.{k}"]
            + GRAPH_LAUNCHES["replayed"][f"{f.__name__}.{k}"] for f, k in COUNTERS]


def _state(tr: Trainer):
    return [t.detach().clone() for group in (tr.params, tr.velocity)
            for p in group for t in p.values()]


@pytest.mark.cuda
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_graph_replays_the_eager_step_bit_for_bit(card, momentum):
    feats, labels = _stack(card)
    out = {}
    for side in ("eager", "graph"):
        profiler.enabled = side == "eager"
        tr = _trainer(card, momentum)
        before = _launched()
        acc = tr.drain_train(feats, labels)
        torch.cuda.synchronize()
        launches = [n - b for n, b in zip(_launched(), before)]
        out[side] = (_state(tr), {k: v.clone() for k, v in acc.items()}, launches)
        if side == "graph":
            # the first bunch ran eagerly, the second was captured, the rest replayed
            assert tr._graph is not None and tr._graph.key[0] == (B, DIMS[0])
        else:
            assert tr._graph is None
    (es, eacc, elaunch), (gs, gacc, glaunch) = out["eager"], out["graph"]
    assert all(torch.equal(a, b) for a, b in zip(es, gs))
    assert sorted(eacc) == sorted(gacc) and all(torch.equal(eacc[k], gacc[k]) for k in eacc)
    assert elaunch == glaunch and elaunch[0] == 2 * NB and elaunch[3] == NB


@pytest.mark.cuda
def test_a_new_learning_rate_takes_a_new_capture(card):
    feats, labels = _stack(card)
    profiler.enabled = False
    tr = _trainer(card, 0.9)
    tr.drain_train(feats[:3], labels[:3])
    first = tr._graph
    tr.set_learning_rate(0.005)
    tr.drain_train(feats[3:4], labels[3:4])          # eager at the new rate
    assert tr._graph is None
    tr.drain_train(feats[4:], labels[4:])
    assert tr._graph is not first and tr._graph.key[3] == 0.005
    # the same steps eagerly
    profiler.enabled = True
    ref = _trainer(card, 0.9)
    ref.drain_train(feats[:3], labels[:3])
    ref.set_learning_rate(0.005)
    ref.drain_train(feats[3:], labels[3:])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(_state(ref), _state(tr)))


@pytest.mark.cuda
def test_new_state_tensors_take_a_new_capture(card):
    """Resident newbob gives each epoch fresh velocities: the graph of the
    old ones is not replayed onto the new ones."""
    from nnet_asr_torch.train.sgd import init_momentum

    feats, labels = _stack(card)
    out = []
    for eager in (False, True):
        profiler.enabled = eager
        tr = _trainer(card, 0.9)
        tr.drain_train(feats[:3], labels[:3])
        first = tr._graph
        tr.velocity = init_momentum(tr.net, 0.9, None)
        tr.drain_train(feats[3:], labels[3:])
        torch.cuda.synchronize()
        if not eager:
            assert first is not None and tr._graph is not first
        out.append(_state(tr))
    assert all(torch.equal(a, b) for a, b in zip(*out))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{"compute_dtype": "bf16"}, {"objective": "mse"},
                                {"confusion_mode": "max"}])
def test_no_graph_off_the_fused_f32_step(card, kw):
    tr = _trainer(card, 0.9, **kw)
    assert not tr._graphable
    profiler.enabled = False
    feats, labels = _stack(card)
    tr.drain_train(feats[:3], labels[:3])
    assert tr._graph is None


@pytest.mark.cuda
def test_a_profiler_session_replays_the_graphs_in_spans(card):
    """Under a ``torch.profiler`` session the step replays, in turns, the
    graphs that hold its spans: the state bit for bit as the plain graph
    leaves it, each span once a step (the timed ones with their device
    time), the counters once a step."""
    from torch.profiler import ProfilerActivity, profile

    feats, labels = _stack(card)
    profiler.enabled = False
    out, n, L = [], NB - 2, len(DIMS) - 1
    for traced in (False, True):
        tr = _trainer(card, 0.9)
        tr.drain_train(feats[:2], labels[:2])            # eager, then the captures
        torch.cuda.synchronize()
        profiler.reset()
        with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if traced
              else contextlib.nullcontext()):
            tr.drain_train(feats[2:], labels[2:])
            torch.cuda.synchronize()
        out.append(_state(tr))
    assert all(torch.equal(a, b) for a, b in zip(*out))
    tot = profiler.totals()
    assert {k: r["calls"] for k, r in tot.items()} == {
        "train-step": 1, "step": n, "step.forward": n, "step.loss": n, "step.backward": n,
        "step.update": n, "forward.output": n, "loss.softmax_ce": n,
        "backward.dgrad": (L - 1) * n, "backward.wgrad": L * n}
    for name in ("step.update", "forward.output", "loss.softmax_ce", "backward.dgrad",
                 "backward.wgrad"):
        assert tot[name]["device_s"] > 0 and tot[name]["host_s"] == 0.0, name
    assert profiler.counters()["step.frames"] == {"adds": n, "sum": n * B}
