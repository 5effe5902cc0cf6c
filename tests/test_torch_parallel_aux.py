"""The port's data-parallel auxiliary trainers against the JAX package's, on
a gloo fleet of 4 CPU ranks (``tests/torch_fleet.py``): CD-1, the MPE
forward and update, the recurrent trainer's batch and ``tmpe --MESH``.

Tolerances are JAX's (``tests/test_parallel_aux.py``): 2e-4 for CD-1 and
the MPE step, 3e-4 for the recurrent batch; ``tmpe`` those of
``tests/test_torch_tmpe.py`` (MMF within 1e-4 relative and 1e-5, the
accuracy within 1e-5). CD-1's noise: JAX draws it from its key, the port
from a torch generator at the global bunch shape, so the JAX side is fed
the port's draw (as ``tests/test_torch_rbm.py`` does).
"""

import contextlib
import io
import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import torch_fleet as fleet
from nnet_asr_tpu.models import (BiasedLinearity, Network, Rbm, RbmSparse, Recurrent,
                                 Sigmoid, Softmax)
from nnet_asr_tpu.models.components import BERNOULLI, GAUSSIAN
from nnet_asr_tpu.models.network import Network as JNetwork
from nnet_asr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nnet_asr_tpu.parallel.sharded_aux import make_sharded_mpe_step as jax_mpe_step
from nnet_asr_tpu.tools import tmpe as jtmpe
from nnet_asr_tpu.train import rbm as jrbm
from nnet_asr_tpu.train.recurrent import RecurrentTrainer as JRecurrentTrainer
from nnet_asr_tpu.train.recurrent import RecurrentTrainerConfig as JRecurrentConfig
from nnet_asr_tpu.train.sgd import SgdConfig, init_momentum
from nnet_asr_torch.train import rbm as trbm
from nnet_asr_torch.train.recurrent import RecurrentTrainer, RecurrentTrainerConfig

KINDS = {"gauss_bern": (BERNOULLI, GAUSSIAN, False), "bern_bern": (BERNOULLI, BERNOULLI, False),
         "bern_gauss": (GAUSSIAN, BERNOULLI, False), "sparse": (BERNOULLI, GAUSSIAN, True)}
CD1 = {f"cd1_{k}_4x1": dict(data=4, model=1, hid=h, vis=v, sparse=s)
       for k, (h, v, s) in KINDS.items()}
CD1["cd1_gauss_bern_2x2"] = dict(data=2, model=2, hid=BERNOULLI, vis=GAUSSIAN, sparse=False)
MPE = {"mpe_4x1": dict(data=4, model=1), "mpe_2x2": dict(data=2, model=2)}
REC = {"rec8_4x1": dict(data=4, model=1, n_utts=8), "rec5_2x2": dict(data=2, model=2, n_utts=5)}
TMPE = {"tmpe_4x1": ("--MESH=4x1", "--LEARNINGRATE=0.5"),
        "tmpe_cv_2x2": ("--MESH=2x2", "-c", "--FBWORKERS=2", "--LOOKAHEAD=2"),
        "tmpe_delayed_2x2": ("--MESH=2x2", "--LEARNINGRATE=0.5", "--DELAYEDUPDATE=TRUE")}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return fleet.phone_corpus(tmp_path_factory.mktemp("phone_corpus"))


@pytest.fixture(scope="module")
def fleet_run(tmp_path_factory, corpus):
    out = tmp_path_factory.mktemp("fleet")
    cases = [(n, "cd1", kw) for n, kw in CD1.items()]
    cases += [(n, "mpe", kw) for n, kw in MPE.items()]
    cases += [(n, "recurrent", kw) for n, kw in REC.items()]
    for n, extra in TMPE.items():
        target = [] if "-c" in extra else [f"--TARGETMMF={out / n}.mmf"]
        cases.append((n, "tool", dict(module="tmpe",
                                      argv=fleet.tmpe_argv(corpus, *extra, *target))))
    return fleet.run_fleet(out, 4, cases), out


def _jax_cd1(kw, seed=0, steps=3, bunch=32):
    """JAX's CD-1 steps over the case's bunches, fed the port's noise."""
    tspec, params, bunches = fleet.rbm_arrays(seed, kw["hid"], kw["vis"], kw["sparse"],
                                              steps, bunch)
    jspec = (RbmSparse if kw["sparse"] else Rbm)(24, 32, vis_type=kw["vis"],
                                                 hid_type=kw["hid"])
    cfg = jrbm.RbmTrainConfig(learning_rate=0.1, momentum=0.5, weightcost=2e-4)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    st = jrbm.init_rbm_state(jspec, p, cfg)
    gen = torch.Generator().manual_seed(seed + 100)
    for X in bunches:
        noise = jnp.asarray(trbm.hidden_noise(tspec, gen, (bunch, 32)).numpy())
        x = jnp.asarray(X)
        pos_hid = jspec.apply(p, x)
        neg_vis = jspec.reconstruct(p, jrbm.sample_hidden(jspec, None, pos_hid, noise=noise))
        neg_hid = jspec.apply(p, neg_vis)
        mse = 0.5 * jnp.sum((neg_vis - x) ** 2)
        p, st = jrbm.apply_rbm_update_from_stats(
            jspec, cfg, p, st, jrbm.cd1_stats(x, pos_hid, neg_vis, neg_hid), bunch)
    return p, st, mse


@pytest.mark.parametrize("name", sorted(CD1))
def test_sharded_cd1_matches_jax(fleet_run, name):
    got = fleet_run[0].get(name)
    p, st, mse = _jax_cd1(CD1[name])
    for k in p:
        np.testing.assert_allclose(got[f"p.{k}"], np.asarray(p[k]), rtol=2e-4, atol=1e-6,
                                   err_msg=k)
    for k in st:
        np.testing.assert_allclose(got[f"s.{k}"], np.asarray(st[k]), rtol=2e-4, atol=1e-6,
                                   err_msg=f"state {k}")
    assert abs(float(got["mse"]) - float(mse)) < 1e-2 * max(float(mse), 1)


def _jax_net(params):
    return Network((BiasedLinearity(16, 32), Sigmoid(32, 32), BiasedLinearity(32, 24),
                    Softmax(24, 24)), [dict(p) for p in params] + [{}])


@pytest.mark.parametrize("name", sorted(MPE))
def test_sharded_mpe_step_matches_jax(fleet_run, name):
    """The gathered log posteriors and the update of JAX's frame-sharded
    MPE step on the same layout."""
    got = fleet_run[0].get(name)
    params, frames = fleet.mpe_arrays(1)
    net = _jax_net(params)
    cfg = SgdConfig(learning_rate=0.05, weightcost=1e-4)
    mesh = jax_make_mesh(data=MPE[name]["data"], model=MPE[name]["model"])
    fwd, upd = jax_mpe_step(net, cfg, mesh)
    p = [{k: jnp.asarray(v) for k, v in q.items()} for q in net.params]
    v = init_momentum(net, cfg.momentum, None)
    for i, (feats, err) in enumerate(frames):
        np.testing.assert_allclose(got[f"logpost{i}"], np.asarray(fwd(p, jnp.asarray(feats))),
                                   rtol=1e-5, atol=1e-6)
        p, v = upd(p, v, jnp.asarray(feats), jnp.asarray(err), jnp.float32(40))
    for i in (0, 2):
        for k in ("weight", "bias"):
            np.testing.assert_allclose(got[f"p{i}.{k}"], np.asarray(p[i][k]), rtol=2e-4,
                                       atol=1e-6, err_msg=f"layer {i} {k}")


@pytest.mark.parametrize("name", sorted(REC))
def test_sharded_recurrent_matches_jax(fleet_run, name):
    """Utterances shard over data (5 over 2 data ranks pads one empty
    utterance); every rank walks the batch's global segment count."""
    kw = REC[name]
    got = fleet_run[0].get(name)
    params, feats, labels = fleet.recurrent_arrays(3, kw["n_utts"])
    jnet = Network((BiasedLinearity(8, 12), Sigmoid(12, 12), Recurrent(12, 12),
                    BiasedLinearity(12, 5), Softmax(5, 5)), [dict(p) for p in params])
    jtr = JRecurrentTrainer(jnet, JRecurrentConfig(bptt_order=3,
                                                   sgd=SgdConfig(**fleet.RECURRENT_SGD)),
                            mesh=jax_make_mesh(data=kw["data"], model=kw["model"]))
    jtr.train_batch(feats, labels)
    for i in (0, 2, 3):
        for k in ("weight", "bias"):
            np.testing.assert_allclose(got[f"p{i}.{k}"], np.asarray(jtr.params[i][k]),
                                       rtol=3e-4, atol=1e-6, err_msg=f"layer {i} {k}")
    assert int(got["frames"]) == jtr.stats.frames
    assert int(got["corr"]) == jtr.stats.corr
    assert abs(float(got["xent"]) - jtr.stats.error) < 1e-3 * max(abs(jtr.stats.error), 1.0)
    # the port's single-device batch, tighter
    ttr = RecurrentTrainer(fleet.torch_recurrent(params),
                           RecurrentTrainerConfig(bptt_order=3,
                                                  sgd=fleet.sgd(**fleet.RECURRENT_SGD)),
                           device="cpu")
    ttr.train_batch(feats, [lab.astype(np.int64) for lab in labels])
    for i, p in enumerate(ttr.net.to_numpy_params()):
        for k, v in p.items():
            np.testing.assert_allclose(got[f"p{i}.{k}"], v, rtol=1e-5, atol=1e-7)


def test_sharded_recurrent_rejects_frame_serial():
    """The frame-serial mode has no data axis (JAX's ValueError); the check
    comes before the mesh is read."""
    params, _, _ = fleet.recurrent_arrays(4, 1)
    with pytest.raises(ValueError, match="frame_serial"):
        RecurrentTrainer(fleet.torch_recurrent(params),
                         RecurrentTrainerConfig(frame_serial=True), mesh=object())


def _tmpe(main, argv, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        assert main(argv, **kw) == 0
    return out.getvalue()


def _acc(log):
    m = re.search(r"Avg MPE accuracy: (\S+) utts: (\d+)", log)
    return float(m.group(1)), int(m.group(2))


@pytest.mark.parametrize("name", sorted(TMPE))
def test_tmpe_mesh_matches_jax(fleet_run, corpus, tmp_path, name):
    """``tmpe --MESH`` (frames padded to a multiple of D with zero rows and
    zero err; rank 0's forward-backward broadcast) against JAX's ``tmpe
    --MESH`` on the same layout; every rank reports the same accuracy."""
    run, out = fleet_run
    extra = TMPE[name]
    crossval = "-c" in extra
    target = [] if crossval else [f"--TARGETMMF={tmp_path / 'jax.mmf'}"]
    jlog = _tmpe(jtmpe.main, fleet.tmpe_argv(corpus, *extra, *target))
    logs = [str(run.get(name, r)["stdout"]) for r in range(4)]
    assert len({_acc(log) for log in logs}) == 1
    (tacc, tn), (jacc, jn) = _acc(logs[0]), _acc(jlog)
    assert tn == jn == 4
    assert tacc == pytest.approx(jacc, abs=1e-5)
    if not crossval:
        tp = JNetwork.read(str(out / f"{name}.mmf")).params
        for a, b in zip(tp, JNetwork.read(str(tmp_path / "jax.mmf")).params):
            for k in a:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-5)
