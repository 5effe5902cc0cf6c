"""The checks catch what they are there for: a whole run on the CPU (the
look for a card skipped) with the timed path broken underneath comes out
not correct, once for each fault the cells can have; the control (the
reference in TF32 put in the program's place) fails the cells' limits;
and the import guard names JAX and the JAX package but not the port."""

import sys
import types

import numpy as np
import pytest
import torch

from benchmark import calibrate, check, harness
from benchmark.run import forbidden_modules
from benchmark.tests import tiny

CELLS = tiny.CELLS


def _tensors(tr):
    out = []
    for group in tr.params + tr.velocity:
        out += [t for t in group.values() if isinstance(t, torch.Tensor)]
    return out


def _frozen(orig):
    def step(self, feats, labels):
        saved = [t.detach().clone() for t in _tensors(self)]
        stats = orig(self, feats, labels)
        with torch.no_grad():
            for t, s in zip(_tensors(self), saved):
                t.copy_(s)
        return stats
    return step


def _half(orig):
    def step(self, feats, labels):
        h = feats.shape[0] // 2
        return orig(self, feats[:h], labels[:h])
    return step


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [_frozen, _half], ids=["state_unchanged", "half_batch"])
def test_broken_step_is_not_correct(monkeypatch, workload, fault):
    from nnet_asr_torch.train.trainer import Trainer

    monkeypatch.setattr(Trainer, "_train_step", fault(Trainer._train_step))
    out = tiny.run(workload)
    assert out["correct"] is False
    assert any(r["value"] > r["limit"] for r in out["checks"].values())


def test_unshuffled_intake_is_not_correct(monkeypatch):
    from nnet_asr_torch.utils.rand48 import Rand48

    monkeypatch.setattr(Rand48, "permutation", lambda self, n: np.arange(n, dtype=np.int64))
    out = tiny.run("prod_tnetcu.stream")
    assert out["correct"] is False and out["checks"]["loss_gap"]["value"] > 1e-3


@pytest.mark.parametrize("workload", ["prod_tnetcu.resident", "prod_tnet_sgd.resident"])
def test_tf32_control_fails_the_limits(workload):
    """At the cell's own widths and bunch (about 20 s on 8 CPU cores)."""
    cell, entry = harness.find(harness.manifest(), workload)
    cfg, mix = harness.load_config(entry), dict(harness.traffic.load(cell["traffic"]))
    cpu = torch.device("cpu")
    want = harness.reference_readings(cfg, mix, 7, cpu)
    control = check.compare(harness.reference_readings(cfg, mix, 7, cpu, None, "tf32"), want)
    ok, rows = check.verdict(control, check.load_limits(workload))
    assert not ok, rows
    assert calibrate.SIDES[0][1] == "tf32"


def test_import_guard(monkeypatch):
    import nnet_asr_torch.train.trainer  # noqa: F401  (the port passes)

    assert "nnet_asr_torch" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "nnet_asr_tpu.models", types.ModuleType("y"))
    assert "nnet_asr_tpu" in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("z"))
    assert {"jax", "nnet_asr_tpu"} <= set(forbidden_modules())
