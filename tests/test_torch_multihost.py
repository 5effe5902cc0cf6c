"""The port's per-rank intake (``--DISTRIBUTED``) and its mesh schedulers
(``scheduler --mesh``, ``--resident --mesh``) on gloo fleets of CPU ranks.

* ``ShardedTrainer(distributed=True)`` on 2 ranks (2x1) and 4 (2x2): the
  ranks of data index d read utterances [d::2] of
  ``tests/multihost_driver.py``'s corpus, agree on each round's bunch
  count and carry the rest, as JAX's two hosts do. Against the JAX
  package's replay of that global bunch sequence
  (``tests/test_multihost.py``, 2e-4), and against the port's
  single-device Trainer fed the same global bunches (1e-5).
* ``scheduler`` on tests/test_resident.py's corpus on a 2x2 mesh:
  streaming (tnet ``--MESH``) and ``--resident`` give the same history and
  byte-identical weight files, under f32 and int8pfsr and with a budget
  that parks stacks on the host; they take the JAX ``scheduler --resident
  --mesh=2x2``'s decisions, best model within 1e-4; ``--distributed``
  streaming and resident agree byte for byte too.
"""

import os
import re

import numpy as np
import pytest
import torch

import multihost_driver as drv
import torch_fleet as fleet
from nnet_asr_tpu.models.network import Network as JNetwork
from nnet_asr_tpu.tools import scheduler as jscheduler
from nnet_asr_torch.train.cache import DeviceFrameCache
from nnet_asr_torch.train.pipeline import TransformPipeline
from nnet_asr_torch.train.trainer import Trainer
from test_multihost import _oracle_replay

# name: scheduler options on the 2x2 mesh
SCHED = {"stream": ("--mesh=2x2",),
         "res": ("--resident", "--mesh=2x2"),
         "res_budget": ("--resident", "--mesh=2x2", "--hbm-budget-mb=0.002"),
         "stream_sr": ("--mesh=2x2", "--compute-dtype=int8pfsr"),
         "res_sr": ("--resident", "--mesh=2x2", "--compute-dtype=int8pfsr"),
         "dist_stream": ("--mesh=2x2", "--distributed"),
         "dist_res": ("--resident", "--mesh=2x2", "--distributed")}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return fleet.resident_corpus(tmp_path_factory.mktemp("resident"))


@pytest.fixture(scope="module")
def fleet2(tmp_path_factory, corpus):
    out = tmp_path_factory.mktemp("fleet2")
    tnet = ["tnet", "-H", str(corpus / "init.mmf"), "-I", str(corpus / "labels.mlf"),
            "-L", "*/", "-X", "lab", "-S", str(corpus / "train.scp"),
            "-m", str(corpus / "phones.map"), "-n", "0.1", "--BUNCHSIZE=32",
            "--CACHESIZE=128", "--SEED=3", "--DISTRIBUTED=TRUE", "--MESH=2x1",
            f"--TARGETMMF={out / 'dist.mmf'}"]
    return fleet.run_fleet(out, 2, [
        ("dist_2x1", "distributed_trainer", dict(data=2, model=1)),
        ("tnet_dist", "tool", dict(module="tnet", argv=tnet))]), out


@pytest.fixture(scope="module")
def fleet4(tmp_path_factory, corpus):
    out = tmp_path_factory.mktemp("fleet4")
    cases = [("dist_2x2", "distributed_trainer", dict(data=2, model=2))]
    cases += [(name, "tool", dict(module="scheduler",
                                  argv=fleet.scheduler_argv(corpus, out / f"w_{name}", *extra)))
              for name, extra in SCHED.items()]
    return fleet.run_fleet(out, 4, cases), out


def _replay():
    """The global bunch sequence of the two data ranks (two local caches,
    the agreed bunch count each round, data rank 0's rows first) through
    the port's single-device Trainer: (params, stats, dropped per rank)."""
    utts = drv.synth_corpus()
    cfg = fleet.trainer_cfg(sgd=fleet.sgd(learning_rate=0.1, momentum=0.5, weightcost=1e-4))
    pipe = TransformPipeline(None, 0, 0, device="cpu")
    caches = []
    for d in range(2):
        cache = DeviceFrameCache(cfg.cachesize // 2, cfg.bunchsize // 2, cfg.seed, True)
        rows, valid = pipe.transform_block([f for f, _ in utts[d::2]])
        cache.add_block(rows, valid, np.concatenate([lab for _, lab in utts[d::2]]))
        caches.append(cache)
    params, _ = fleet.mlp_arrays(3, din=12, dh=24, dout=15, n_bunches=0)
    net = fleet.torch_mlp(params)
    tr = Trainer(net, cfg, device="cpu")
    while True:
        agreed = min(min(c.rows, c.cachesize) // (cfg.bunchsize // 2) for c in caches)
        if agreed == 0:
            break
        parts = [c.take_stacked(max_bunches=agreed) for c in caches]
        feats, labels = (torch.cat([p[i] for p in parts], dim=1) for i in (0, 1))
        tr.merge_acc(tr.stats, tr.drain_train(feats, labels), labels.numel())
    return net.to_numpy_params(), tr.stats, [c.rows for c in caches]


@pytest.mark.parametrize("name,data,model", [("dist_2x1", 2, 1), ("dist_2x2", 2, 2)])
def test_distributed_matches_jax_replay(fleet2, fleet4, name, data, model):
    run = (fleet2 if model == 1 else fleet4)[0]
    world = data * model
    got = [run.get(name, r) for r in range(world)]
    for g in got[1:]:
        for k in ("p0.weight", "p2.weight", "p2.bias"):
            np.testing.assert_array_equal(g[k], got[0][k])
    # each data rank read only its own shard
    assert int(got[0]["read"]) != int(got[model]["read"])
    want, stats, dropped = _replay()
    g = got[0]
    assert int(g["frames"]) == stats.frames > 0
    assert int(g["corr"]) == stats.corr
    for i, p in enumerate(want):
        for k, v in p.items():
            np.testing.assert_allclose(g[f"p{i}.{k}"], v, rtol=1e-5, atol=1e-7)
    # each rank names the frames it drops
    for r in range(world):
        n = dropped[r // model]
        assert (f"rank {r}: dropping {n} unmatched frames" in run.logs[r]) == (n > 0)
    jparams, jstats = _oracle_replay(data, model)
    assert int(g["frames"]) == jstats["frames"]
    assert int(g["corr"]) == jstats["corr"]
    assert abs(float(g["xent"]) - jstats["xent"]) < 0.05
    for i in (0, 2):
        for k in ("weight", "bias"):
            np.testing.assert_allclose(g[f"p{i}.{k}"], np.asarray(jparams[i][k]),
                                       rtol=2e-4, atol=1e-6)


def test_tnet_distributed_tool(fleet2, corpus):
    run, out = fleet2
    for r in range(2):
        assert f"[distributed] rank {r} (data {r}/2): 5 SCP entries in local shard" in run.logs[r]
    log = str(run.get("tnet_dist")["stdout"])
    assert "mesh=data:2xmodel:1" in log
    got = JNetwork.read(str(out / "dist.mmf")).params
    init = JNetwork.read(str(corpus / "init.mmf")).params
    assert all(np.isfinite(p[k]).all() for p in got for k in p)
    assert not np.allclose(got[0]["weight"], init[0]["weight"])


def _history(out):
    return re.findall(r"(TR|CV) accuracy:\s*([\d.]+) iter: (\d+)", out)


def _decisions(out):
    return re.findall(r"^(accepting weights|reverting the weights.*|lrate=.*)$", out, re.M)


def _best(out):
    return re.search(r"Best model: (\S+) \(CV", out).group(1)


def _same_weights(dir_a, dir_b):
    names = sorted(os.listdir(dir_a))
    assert names and names == sorted(os.listdir(dir_b))
    for n in names:
        assert (dir_a / n).read_bytes() == (dir_b / n).read_bytes(), f"weights differ: {n}"


@pytest.mark.parametrize("a,b", [("stream", "res"), ("res", "res_budget"),
                                 ("stream_sr", "res_sr"), ("dist_stream", "dist_res")])
def test_mesh_scheduler_modes_agree(fleet4, a, b):
    run, out = fleet4
    log_a, log_b = (str(run.get(n)["stdout"]) for n in (a, b))
    assert len(_history(log_a)) >= 4          # two newbob iterations or more
    assert _history(log_a) == _history(log_b)
    assert _decisions(log_a) == _decisions(log_b)
    _same_weights(out / f"w_{a}", out / f"w_{b}")
    if "res" in b.split("_"):
        assert "(resident, mesh)" in log_b
    if b == "res_budget":
        assert "host-parked" in log_b
    # every rank took the same decisions
    for r in range(1, 4):
        assert _decisions(str(run.get(b, r)["stdout"])) == _decisions(log_b)


def test_resident_mesh_matches_jax_resident_mesh(fleet4, corpus, tmp_path):
    run, out = fleet4
    log_t = str(run.get("res")["stdout"])
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jscheduler.main(fleet.scheduler_argv(corpus, tmp_path / "jax",
                                                    "--resident", "--mesh=2x2")) == 0
    log_j = buf.getvalue()
    assert "(resident, mesh)" in log_j
    assert _decisions(log_t) == _decisions(log_j)
    best_t, best_j = _best(log_t), _best(log_j)
    assert os.path.basename(best_t) == os.path.basename(best_j)
    for x, y in zip(JNetwork.read(best_t).params, JNetwork.read(best_j).params):
        for k in x:
            np.testing.assert_allclose(x[k], y[k], atol=1e-4, rtol=0)
