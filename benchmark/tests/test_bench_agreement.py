"""At tiny widths on the CPU, the plain reference agrees with
``nnet_asr_torch``'s CPU path (its kernels' plain versions) through one
resident drain and one streamed epoch, and a run's result line keeps the
contract's schema."""

import json
import shutil
import tempfile

import pytest
import torch

from benchmark import check, harness, traffic
from benchmark.program import Program
from benchmark.reference import mlp_frame_ce, stream_intake
from benchmark.tests import tiny

SEED = 2 ** 31 + 5
CPU = torch.device("cpu")


def _rel(got, want):
    return max(float((g.detach() - w).norm() / w.norm()) for (_, g, _), (_, w, _) in
               zip(got, want))


def _reference(cfg, bunches):
    box = {}

    def keep(k, loss, leaves):
        box.setdefault("loss", []).append(loss)
        box["leaves"] = leaves

    mlp_frame_ce.run(cfg, traffic.weights(cfg, SEED, CPU), bunches, keep)
    return sum(box["loss"][1:]), box["leaves"]


@pytest.mark.parametrize("config", ["prod_tnetcu", "prod_tnet_sgd"])
def test_one_resident_drain(config):
    cfg, mix = tiny.configs()[config], tiny.MIXES["resident"]
    prog = Program(cfg, mix, SEED, CPU)
    feats, labels = prog.stacks[0]
    acc = prog.trainer.drain_train(feats, labels)
    loss, leaves = _reference(cfg, list(zip(feats, labels)))
    assert float(acc["xent"]) == pytest.approx(loss, rel=1e-6)
    assert _rel(prog.leaves(), leaves) < 1e-6


def test_one_streamed_epoch():
    cfg, mix = tiny.configs()["prod_tnetcu"], tiny.MIXES["stream"]
    d = tempfile.mkdtemp()
    try:
        corpus = traffic.write_corpus(cfg, mix, SEED, d, CPU)
        prog = Program(cfg, mix, SEED, CPU, corpus)
        gen, utts = prog._epoch_stacks()
        got, n_bunches = 0.0, 0
        for feats, labels in gen:
            got += float(prog.trainer.drain_train(feats, labels)["xent"])
            n_bunches += feats.shape[0]
        utts.close()
        bunches = list(stream_intake.epoch_bunches(cfg, mix, SEED, (corpus["bias"],
                                                                    corpus["window"]), CPU))
        # the whole caches and the last partial one, sub-bunch tails dropped
        assert n_bunches == len(bunches) > mix["cache_frames"] // cfg["bunch"]
        loss, leaves = _reference(cfg, bunches)
        assert got == pytest.approx(loss, rel=1e-6)
        assert _rel(prog.leaves(), leaves) < 1e-5
    finally:
        shutil.rmtree(d)


@pytest.mark.parametrize("workload", tiny.CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_result_line(workload, traced):
    out = tiny.run(workload, traced)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[:5] == keys and list(out)[-1] == "checks"
    assert set(out) == set(keys) | {"checks"} | ({"breakdown"} if traced else set())
    want = {m["name"]: m["unit"] for m in harness.cell_metrics(tiny.manifest(), workload,
                                                               traced)}
    assert set(out["metrics"]) <= set(want)
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == want[name]
        assert isinstance(m["value"], float)
    if not traced:
        assert set(out["metrics"]) == set(want)
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["checks"]) == set(check.NUMBERS)
    for row in out["checks"].values():
        assert row["value"] <= row["limit"]
    if traced:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert out["device"]["window_s"] > 0
    json.dumps(out)
