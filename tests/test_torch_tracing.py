"""The profiler's spans and counters inside the port's training step and
intake, on the CPU: calls per step, each step's spans and their nesting,
self times, nothing recorded with tracing off, the ranges in a
``torch.profiler`` trace and which spans it times on the card, training
unchanged by tracing, and the reader threads' spans."""

import numpy as np
import pytest
import torch

from nnet_asr_torch.models.components import BiasedLinearity, Sigmoid, Softmax
from nnet_asr_torch.models.network import Network
from nnet_asr_torch.train.sgd import SgdConfig
from nnet_asr_torch.train.trainer import Trainer, TrainerConfig, read_utterances
from nnet_asr_torch.utils import profiler as profiler_module
from nnet_asr_torch.utils.profiler import profiler

DIMS = [24, 32, 32, 32, 32, 40]       # five affine layers, four sigmoids
B, NB = 16, 3
MOMENTA = [0.0, 0.9]
STEP_CALLS = {"step": 1, "step.forward": 1, "step.loss": 1, "step.backward": 1,
              "step.update": 1, "forward.output": 1, "loss.softmax_ce": 1, "backward.dgrad": 4, "backward.wgrad": 5}
PARENT = {"train-step": None, "step": "train-step", "step.forward": "step",
          "step.loss": "step", "step.backward": "step", "step.update": "step",
          "forward.output": "step.forward",
          "loss.softmax_ce": "step.loss", "backward.dgrad": "step.backward",
          "backward.wgrad": "step.backward"}
LAYERS = list(zip(DIMS[:-1], DIMS[1:]))


@pytest.fixture
def prof():
    was = profiler.enabled
    profiler.enabled = False
    profiler.reset()
    yield profiler
    profiler.enabled = was
    profiler.reset()


def _trainer(momentum: float, ext: int = 0, linear: int = -1) -> Trainer:
    """The five-layer net; hidden layer ``linear`` (if any) without its
    sigmoid, a linear bottleneck."""
    gen = torch.Generator().manual_seed(11)
    layers = []
    for i, (n_in, n_out) in enumerate(zip(DIMS[:-1], DIMS[1:])):
        layers.append(BiasedLinearity(n_in, n_out))
        if i == len(DIMS) - 2:
            layers.append(Softmax(n_out, n_out))
        elif i != linear:
            layers.append(Sigmoid(n_out, n_out))
    net = Network(layers)
    with torch.no_grad():
        for spec in net.layers:
            if isinstance(spec, BiasedLinearity):
                spec.weight.copy_(0.3 * torch.randn(spec.weight.shape, generator=gen))
                spec.bias.copy_(0.1 * torch.randn(spec.bias.shape, generator=gen))
    sgd = SgdConfig(learning_rate=0.02, momentum=momentum)
    return Trainer(net, TrainerConfig(bunchsize=B, cachesize=B * NB, seed=5, sgd=sgd),
                   None, ext, ext, device="cpu")


def _stack(seed: int = 4):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((NB, B, DIMS[0]), generator=gen),
            torch.randint(0, DIMS[-1], (NB, B), generator=gen, dtype=torch.int32))


def _weights(tr: Trainer):
    return [t.detach().clone() for p in tr.params for t in p.values()]


@pytest.mark.parametrize("momentum", MOMENTA)
def test_calls_and_counters_per_step(prof, momentum):
    prof.enabled = True
    _trainer(momentum).drain_train(*_stack())
    tot = prof.totals()
    for name, per_step in STEP_CALLS.items():
        assert tot[name]["calls"] == per_step * NB, name
    assert tot["train-step"]["calls"] == 1
    assert prof.counters()["step.frames"] == {"adds": NB, "sum": NB * B}
    # on the CPU no span times a device
    assert all(r["device_s"] is None and r["device_self_s"] is None for r in tot.values())


@pytest.mark.parametrize("momentum", MOMENTA)
def test_gemm_operations_are_counted_by_route(prof, momentum):
    """Every product of a step adds its 2·M·N·K operations where its route
    is chosen: the forward and the weight gradient of each layer and the
    input gradient of every layer but the first. On the CPU the library
    forms them all."""
    prof.enabled = True
    _trainer(momentum).drain_train(*_stack())
    flops = {k: c for k, c in prof.counters().items() if k.startswith("gemm.flops.")}
    fwd = sum(2 * B * i * o for i, o in LAYERS)
    dgrad = sum(2 * B * i * o for i, o in LAYERS[1:])
    assert flops == {"gemm.flops.library": {"adds": NB * (2 * len(LAYERS) + len(LAYERS) - 1),
                                            "sum": NB * (2 * fwd + dgrad)}}


@pytest.mark.parametrize("momentum", MOMENTA)
def test_each_step_closes_its_spans_and_they_nest(prof, momentum):
    """Bunch by bunch: each step adds its own spans once each, all closed
    when it returns, and each span's time covers its children's."""
    prof.enabled = True
    tr, (feats, labels) = _trainer(momentum), _stack()
    for k in range(NB):
        tr.drain_train(feats[k:k + 1], labels[k:k + 1])
        tot = prof.totals()
        assert {n: tot[n]["calls"] for n in STEP_CALLS} == {
            n: c * (k + 1) for n, c in STEP_CALLS.items()}
        assert tot["train-step"]["calls"] == k + 1
        for name in PARENT:
            children = [c for c, p in PARENT.items() if p == name]
            assert tot[name]["host_s"] >= sum(tot[c]["host_s"] for c in children)


def test_the_output_span_is_the_output_layer(prof):
    """A hidden BiasedLinearity without a sigmoid goes through the same
    ``affine`` as the output layer, and is no ``forward.output``."""
    prof.enabled = True
    _trainer(0.9, linear=1).drain_train(*_stack())
    tot = prof.totals()
    assert tot["forward.output"]["calls"] == NB
    assert tot["backward.dgrad"]["calls"] == 4 * NB
    assert tot["backward.wgrad"]["calls"] == 5 * NB


@pytest.mark.parametrize("momentum", MOMENTA)
def test_self_times_add_up_to_the_parents(prof, momentum):
    prof.enabled = True
    _trainer(momentum).drain_train(*_stack())
    tot = prof.totals()
    for name, parent in PARENT.items():
        children = [c for c, p in PARENT.items() if p == name]
        want = tot[name]["host_s"] - sum(tot[c]["host_s"] for c in children)
        assert tot[name]["host_self_s"] == pytest.approx(want, rel=1e-9, abs=1e-12)
        assert tot[name]["host_self_s"] >= 0
    # one thread: the self times of every span cover the outermost one
    assert sum(r["host_self_s"] for r in tot.values()) == pytest.approx(
        tot["train-step"]["host_s"], rel=1e-9)


def test_tracing_off_records_nothing(prof, monkeypatch):
    ranges = []

    class Range:
        def __init__(self, name, *args):
            ranges.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(profiler_module, "_Range", Range)
    assert not prof.recording()
    assert prof.phase("a") is prof.phase("b")          # the shared null context
    # off, the step opens every span it opens when on, and each is the
    # shared null context
    asked = []
    phase = prof.phase

    def asking(name, *args, **kwargs):
        asked.append((name, phase(name, *args, **kwargs)))
        return asked[-1][1]

    monkeypatch.setattr(prof, "phase", asking)
    _trainer(0.9).drain_train(*_stack())
    assert {n for n, _ in asked} == set(PARENT) | {"train-step"}
    assert all(ctx is phase("x") for _, ctx in asked)
    assert prof.totals() == {} and prof.counters() == {}
    assert ranges == []
    # on, but no torch.profiler session: spans and no ranges
    prof.enabled = True
    _trainer(0.9).drain_train(*_stack())
    assert prof.totals()["step"]["calls"] == NB and ranges == []


@pytest.mark.parametrize("momentum", MOMENTA)
def test_profiler_trace_carries_the_ranges(prof, momentum):
    from torch.profiler import ProfilerActivity, profile, record_function

    tr, stack = _trainer(momentum), _stack()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with record_function("window"):
            tr.drain_train(*stack)
    events = list(p.profiler.kineto_results.events())
    (win,) = [ev for ev in events if ev.name() == "window"]
    got = {}
    for ev in events:
        if ev.name() in PARENT:
            # a host range, which the profiler mirrors onto no device timeline
            assert str(ev.activity_type()) == "cpu_op" and "CPU" in str(ev.device_type())
            assert win.start_ns() <= ev.start_ns() and ev.end_ns() <= win.end_ns()
            got[ev.name()] = got.get(ev.name(), 0) + 1
    assert got == {**{n: c * NB for n, c in STEP_CALLS.items()}, "train-step": 1}
    # the session alone turns the spans on
    assert not prof.enabled and prof.totals()["backward.dgrad"]["calls"] == 4 * NB


def test_a_profiler_session_times_the_read_spans_alone(prof):
    """Under ``torch.profiler`` alone only spans opened ``timed_in_trace``
    time the card; under ``-T 4`` every span given a device does."""
    from torch.profiler import ProfilerActivity, profile

    card = torch.device("cuda", 0)
    with profile(activities=[ProfilerActivity.CPU]):
        assert prof.recording()
        assert prof.phase("step", card).device is None
        assert prof.phase("backward.dgrad", card, timed_in_trace=True).device == 0
        assert prof.phase("intake.wait").device is None
    prof.enabled = True
    assert prof.phase("step", card).device == 0
    assert prof.phase("step", torch.device("cpu")).device is None


@pytest.mark.parametrize("momentum", MOMENTA)
def test_training_is_unchanged_by_tracing(prof, momentum):
    from torch.profiler import ProfilerActivity, profile

    stack = _stack()
    off = _trainer(momentum)
    off.drain_train(*stack)
    prof.enabled = True
    on = _trainer(momentum)
    on.drain_train(*stack)
    prof.enabled = False
    traced = _trainer(momentum)
    with profile(activities=[ProfilerActivity.CPU]):
        traced.drain_train(*stack)
    for a, b, c in zip(_weights(off), _weights(on), _weights(traced)):
        assert torch.equal(a, b) and torch.equal(a, c)


class _Header:
    sample_period = 100000


class _Reader:
    """Utterance ``k`` has ``10 + k`` frames plus the halo."""

    def __init__(self):
        self.last_header = None

    def read(self, physical, logical):
        self.last_header = _Header()
        return np.full((10 + int(physical) + 2, DIMS[0]), float(physical), np.float32)


class _Labels:
    def get_frame_labels(self, n, period, logical):
        return np.arange(n, dtype=np.int32) % DIMS[-1]


class _Entry:
    def __init__(self, k):
        self.physical = self.logical = str(k)


def test_intake_spans_from_reader_threads_count_once(prof):
    prof.enabled = True
    n = 23
    utts = read_utterances(_Reader(), [_Entry(k) for k in range(n)], _Labels(), 1, 1,
                           workers=3)
    tr = _trainer(0.0, ext=1)
    stacks = list(tr.stacks(utts, True, batch_utts=4))
    frames = sum(10 + k for k in range(n))
    tot, cnt = prof.totals(), prof.counters()
    assert tot["intake.read"]["calls"] == tot["intake.labels"]["calls"] == n
    assert cnt["intake.utterances"] == {"adds": n, "sum": n}
    assert cnt["intake.frames"] == {"adds": n, "sum": frames}
    assert tot["intake.wait"]["calls"] == n + 1        # the last finds the end
    batches = -(-n // 4)
    assert tot["transform"]["calls"] == tot["intake.fill"]["calls"] == batches
    # every take shuffles; the last, under a bunch, gathers nothing
    takes = tot["cache-randomize"]["calls"]
    assert tot["intake.shuffle"]["calls"] == takes == len(stacks) + 1
    assert tot["intake.gather"]["calls"] == len(stacks)
    assert sum(s[1].numel() for s in stacks) == tr.total_frames - frames % B
    # the readers' spans open on their own threads, under no span of the
    # main thread's; the shuffle and the gather under the take
    for name in ("intake.wait", "intake.read", "intake.labels"):
        assert tot[name]["host_self_s"] == tot[name]["host_s"]
    take = tot["cache-randomize"]
    assert take["host_self_s"] == pytest.approx(
        take["host_s"] - tot["intake.shuffle"]["host_s"] - tot["intake.gather"]["host_s"],
        rel=1e-9, abs=1e-12)


class _GraphEvent:
    """A stand-in for a CUDA event captured into a graph: its time (ms) is
    the one the card stamps at each replay."""

    def __init__(self, t: float):
        self.t = t

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return end.t - self.t


def test_a_captured_step_records_its_spans_once_a_replay(prof, monkeypatch):
    """What a step records while a CUDA graph captures it goes into the
    capture's ``GraphSpans``, not the totals; each replay adds its spans
    (device time from the graph's events, no host time) and its counters
    once, and folds the last replay of the same graph before it launches."""
    from types import SimpleNamespace

    times = iter([0.0, 1.0, 3.0, 4.0])       # step opens, inner opens, closes, step closes
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    monkeypatch.setattr(prof, "_event", lambda index, graph=False: _GraphEvent(next(times)))
    dev = SimpleNamespace(type="cuda", index=0)
    spans = profiler_module.GraphSpans()
    assert not prof.recording()
    with prof.capturing(spans):
        assert prof.recording()
        with prof.phase("step", dev, timed_in_trace=True):
            prof.count("step.frames", 16)
            with prof.phase("inner", dev, timed_in_trace=True):
                pass
            with prof.phase("host-only", dev):
                pass
    assert not prof.recording()
    assert prof.totals() == {} and prof.counters() == {}
    assert [s.name for s in spans.spans] == ["inner", "host-only", "step"]
    assert spans.counts == [("step.frames", 16)]
    # a replay while the graph's last replay waits for its fold folds it first
    live_at_launch = []
    for _ in range(3):
        prof.replay(spans, lambda: live_at_launch.append(spans.live))
    assert live_at_launch == [False, False, False] and spans.live
    tot = prof.totals()
    assert not spans.live
    assert tot["inner"] == {"calls": 3, "host_s": 0.0, "host_self_s": 0.0,
                            "device_s": pytest.approx(0.006), "device_self_s": pytest.approx(0.006)}
    assert tot["step"]["device_s"] == pytest.approx(0.012)
    assert tot["step"]["device_self_s"] == pytest.approx(0.006)
    assert tot["host-only"] == {"calls": 3, "host_s": 0.0, "host_self_s": 0.0,
                                "device_s": None, "device_self_s": None}
    assert prof.counters() == {"step.frames": {"adds": 3, "sum": 48}}
    prof.replay(spans, lambda: None)
    prof.reset()
    assert not spans.live and prof.totals() == {}
    # a capture into no spans records nothing, even under -T 4
    prof.enabled = True
    with prof.capturing(None):
        assert not prof.recording()
        assert prof.phase("step", dev) is prof.phase("inner", dev)
        prof.count("step.frames", 16)
    assert prof.totals() == {} and prof.counters() == {}
