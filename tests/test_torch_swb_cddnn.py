"""Seide et al.'s Switchboard CD-DNN (429 -> 2048x7 -> 9304, sigmoid
hidden layers, softmax over 9,304 senones) through the port's training
path on the CPU, against the benchmark's plain reference
(``benchmark/reference/mlp_frame_ce.py``) on seeded random weights.

The published depth, input width and class count, with the hidden layers
narrowed to 64 so that the CPU run takes a second: the benchmark's
``Program`` builds the Trainer as the ``swb_cddnn.resident`` cell does and
drives its first three steps through ``drain_train``, a bunch a call; the
reference trains from the same weights on the same bunches. Compared
after each step: the bunch's summed Xent; after step 1 each leaf's first
gradient (the velocity with momentum, ``(W0 - W1) / a`` without); after
step 3 each leaf's change ``W3 - W0``.

Tolerances: both sides are float32 on the CPU and differ only in the order
of their sums (autograd and the kernels' plain versions against a
hand-written backward). A leaf is measured against the larger of its own
and the median leaf's reference norm, as ``benchmark/check.py`` does, so
that a near-zero bias gradient is not judged on rounding alone. Over 16
seeds the largest readings were 1.8e-7 (loss), 2.1e-7 (first gradient,
momentum 0.9), 3.3e-4 (first gradient, momentum 0: ``(W0 - W1) / a``
carries the rounding of the stored W1) and 1.9e-4 (change: the rounding
of the stored W3); rounding every product's operands to TF32 (the
reference's ``tf32`` control, the next precision below float32) read at
least 7.5e-7, 4.2e-4, 3.1e-3 and 4.3e-3. Each limit lies between the two,
and the TF32 control fails at least one of them.
"""

import statistics

import pytest
import torch

from benchmark import harness, traffic
from benchmark.program import Program
from benchmark.reference import mlp_frame_ce
from benchmark.reference.mlp_frame_ce import step_coeff

torch.set_num_threads(2)

CPU = torch.device("cpu")
SEED = 2 ** 31 + 23
STEPS = 3
DIMS = [429] + [64] * 7 + [9304]
MIX = {"kind": "resident", "stacks": 1, "stack_bunches": 8, "trace_seconds": 0.1}
# (loss, first gradient, change) limits by momentum: see the module doc
LIMITS = {0.9: {"loss": 2e-6, "grad": 2e-5, "change": 1e-3},
          0.0: {"loss": 2e-6, "grad": 1e-3, "change": 1e-3}}


def _config(momentum: float) -> dict:
    man = harness.manifest()
    cfg = harness.load_config(next(c for c in man["configs"] if c["name"] == "swb_cddnn"))
    return dict(cfg, dims=DIMS, bunch=32, momentum=momentum)


class _Keep:
    """Each step's loss, the first gradient and the change after step 3,
    leaf by leaf."""

    def __init__(self, cfg: dict):
        self.cfg, self.loss, self.grad, self.change, self.w0 = cfg, [], {}, {}, {}

    def __call__(self, k, loss, leaves):
        if k == 0:
            self.w0 = {n: p.detach().double().clone() for n, p, _ in leaves}
            return
        self.loss.append(float(loss))
        if k == 1:
            a = step_coeff(self.cfg, self.cfg["bunch"])
            self.grad = {n: (v.detach().double().clone() if v is not None
                             else (self.w0[n] - p.detach().double()) / a)
                         for n, p, v in leaves}
        if k == STEPS:
            self.change = {n: p.detach().double() - self.w0[n] for n, p, _ in leaves}


def _gap(got: dict, want: dict) -> float:
    """The worst leaf's difference over the larger of its and the median
    leaf's reference norm."""
    norms = {k: float(v.norm()) for k, v in want.items()}
    med = statistics.median(norms.values())
    return max(float((got[k] - want[k]).norm()) / max(norms[k], med) for k in want)


def _reference(cfg: dict, bunches, precision: str = "f32") -> _Keep:
    keep = _Keep(cfg)
    mlp_frame_ce.run(cfg, traffic.weights(cfg, SEED, CPU), bunches, keep, precision)
    return keep


def _gaps(got: _Keep, want: _Keep) -> dict:
    return {"loss": max(abs(a - b) / abs(b) for a, b in zip(got.loss, want.loss)),
            "grad": _gap(got.grad, want.grad), "change": _gap(got.change, want.change)}


@pytest.fixture(scope="module", params=[0.9, 0.0], ids=["momentum", "plain"])
def steps(request):
    cfg = _config(request.param)
    prog = Program(cfg, MIX, SEED, CPU)
    got = _Keep(cfg)
    prog.first_steps(got, STEPS)
    feats, labels = prog.stacks[0]
    bunches = [(feats[k], labels[k]) for k in range(STEPS)]
    return cfg, got, bunches


def test_the_port_trains_as_the_reference(steps):
    cfg, got, bunches = steps
    want = _reference(cfg, bunches)
    assert len(got.loss) == len(want.loss) == STEPS
    # the leaves of all eight layers, the output layer's 9,304 biases too
    assert sorted(got.grad) == sorted(want.grad) == sorted(
        f"{t}{n}" for n in range(1, len(DIMS)) for t in "Wb")
    assert got.change["W8"].shape == (64, 9304)
    gaps, limits = _gaps(got, want), LIMITS[cfg["momentum"]]
    assert all(gaps[k] <= limits[k] for k in limits), gaps
    # every leaf moved
    assert all(float(v.norm()) > 0 for v in want.change.values())


def test_tf32_products_fail_a_limit(steps):
    """The limits are tighter than the next precision below float32."""
    cfg, _, bunches = steps
    gaps, limits = (_gaps(_reference(cfg, bunches, "tf32"), _reference(cfg, bunches)),
                    LIMITS[cfg["momentum"]])
    assert any(gaps[k] > limits[k] for k in limits), gaps
