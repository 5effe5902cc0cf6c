"""The port's ShardedTrainer and ``tnet --MESH`` against the JAX package's,
on the CPU.

The port runs on gloo fleets of CPU ranks (``tests/torch_fleet.py``): one
of 4 ranks for the (4, 1) and (2, 2) cases, the checkpoint interop and the
tnet runs, one of 6 for (2, 3) (JAX ``tests/test_sharded_trainer.py:34``).
The JAX package runs the same inputs on its 8-device virtual mesh in the
pytest process. Tolerances: JAX's trainer one (5e-3 relative on the
weights, the same frames, the correct count within 2 frames) against JAX;
the port's mesh against its own single-device Trainer within 1e-5.
"""

import contextlib
import io
import re

import numpy as np
import pytest

import torch_fleet as fleet
from nnet_asr_tpu.models import BiasedLinearity, Network, Sigmoid, Softmax
from nnet_asr_tpu.models.network import Network as JNetwork
from nnet_asr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nnet_asr_tpu.parallel.sharded_trainer import ShardedTrainer as JShardedTrainer
from nnet_asr_tpu.tools import tnet as jtnet
from nnet_asr_tpu.train.sgd import SgdConfig
from nnet_asr_tpu.train.trainer import Trainer as JTrainer
from nnet_asr_tpu.train.trainer import TrainerConfig as JTrainerConfig
from nnet_asr_torch.tools import tnet as ttnet
from nnet_asr_torch.tools.synth_corpus import CorpusShape, make_corpus
from nnet_asr_torch.train.trainer import Trainer

SHAPE = CorpusShape(feat_dim=5, ext=3, dct=4, hidden=24, classes=6, n_train=15,
                    n_cv=0, min_frames=20, max_frames=40)


def _tnet_argv(d, src, *extra):
    return ["tnet", "-H", str(src), "-I", str(d / "labs.mlf"), "-L", "*/", "-X", "lab",
            "-S", str(d / "train.scp"), "-m", str(d / "map"), "-n", "0.05",
            "--BUNCHSIZE=16", "--CACHESIZE=64", "--SEED=123",
            f"--FEATURETRANSFORM={d / 'transform'}",
            f"--STARTFRMEXT={SHAPE.ext}", f"--ENDFRMEXT={SHAPE.ext}", *extra]


# name: (tnet options); each runs on every rank of the 4-rank fleet
TNET = {"tnet_2x2": ("--MESH=2x2",),
        "tnet_4x1_momentum": ("--MESH=4x1", "--MOMENTUM=0.5"),
        "tnet_1x4_padded": ("--MESH=1x4",)}        # 6 senones padded to 8


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    make_corpus(str(d), SHAPE, seed=21)
    return d


@pytest.fixture(scope="module")
def fleet4(tmp_path_factory, corpus):
    out = tmp_path_factory.mktemp("fleet4")
    cases = [("trainer_4x1", "sharded_trainer", dict(data=4, model=1)),
             ("trainer_2x2", "sharded_trainer", dict(data=2, model=2)),
             ("cv_4x1", "sharded_trainer", dict(data=4, model=1, crossvalidate=True)),
             ("checkpoint", "checkpoint", dict(data=2, model=2))]
    for name, extra in TNET.items():
        argv = _tnet_argv(corpus, corpus / "init.mmf", f"--TARGETMMF={out / name}.mmf", *extra)
        cases.append((name, "tool", dict(module="tnet", argv=argv)))
    cv = _tnet_argv(corpus, out / "tnet_2x2.mmf", "-c", "--MESH=2x2")
    cases.append(("tnet_cv_2x2", "tool", dict(module="tnet", argv=cv)))
    return fleet.run_fleet(out, 4, cases), out


@pytest.fixture(scope="module")
def fleet6(tmp_path_factory):
    return fleet.run_fleet(tmp_path_factory.mktemp("fleet6"), 6,
                           [("trainer_2x3", "sharded_trainer", dict(data=2, model=3))])


def _jax_trainer(data, model, crossvalidate=False):
    params, _ = fleet.mlp_arrays(0, din=12, dh=24, dout=15, n_bunches=0)
    net = Network((BiasedLinearity(12, 24), Sigmoid(24, 24), BiasedLinearity(24, 15),
                   Softmax(15, 15)), [dict(p) for p in params] + [{}])
    cfg = JTrainerConfig(bunchsize=32, cachesize=64 if crossvalidate else 128, seed=7,
                         randomize=not crossvalidate, crossvalidate=crossvalidate,
                         sgd=SgdConfig(learning_rate=0.1, momentum=0.5))
    tr = JShardedTrainer(net, cfg, jax_make_mesh(data=data, model=model))
    tr.run_epoch(iter(fleet.trainer_utts(0, n=4 if crossvalidate else 12)))
    return tr


def _torch_single():
    params, _ = fleet.mlp_arrays(0, din=12, dh=24, dout=15, n_bunches=0)
    net = fleet.torch_mlp(params)
    tr = Trainer(net, fleet.trainer_cfg(), device="cpu")
    tr.run_epoch(iter(fleet.trainer_utts(0)))
    return tr


@pytest.mark.parametrize("name,data,model", [("trainer_4x1", 4, 1), ("trainer_2x2", 2, 2),
                                             ("trainer_2x3", 2, 3)])
def test_sharded_trainer_matches_jax(fleet4, fleet6, name, data, model):
    run = fleet6 if model == 3 else fleet4[0]
    got = run.get(name)
    jt = _jax_trainer(data, model)
    assert int(got["frames"]) == jt.stats.frames
    assert abs(int(got["corr"]) - jt.stats.corr) <= 2
    assert abs(float(got["xent"]) - jt.stats.error) < 0.5
    jp = jt.updated_network().params
    for i in (0, 2):
        np.testing.assert_allclose(got[f"p{i}.weight"], np.asarray(jp[i]["weight"]),
                                   rtol=5e-3, atol=1e-5)
    assert f"mesh=data:{data}xmodel:{model}" in str(got["report"])
    # the same global bunches as the port's single-device Trainer
    single = _torch_single()
    assert int(got["frames"]) == single.stats.frames
    assert int(got["corr"]) == single.stats.corr
    for i, p in enumerate(single.net.to_numpy_params()):
        for k, v in p.items():
            np.testing.assert_allclose(got[f"p{i}.{k}"], v, rtol=1e-5, atol=1e-7)


def test_sharded_trainer_crossvalidate(fleet4):
    got = fleet4[0].get("cv_4x1")
    jt = _jax_trainer(4, 1, crossvalidate=True)
    assert int(got["frames"]) == jt.stats.frames > 0
    assert int(got["corr"]) == jt.stats.corr
    params, _ = fleet.mlp_arrays(0, din=12, dh=24, dout=15, n_bunches=0)
    np.testing.assert_array_equal(got["p0.weight"], params[0]["weight"])


def test_checkpoint_interop_single_device_and_mesh(fleet4):
    """tests/test_checkpoint.py's interop case: 5 senones padded to 6 on a
    2x2 mesh; the mesh state is saved unpadded and loads anywhere."""
    run, out = fleet4
    for r in range(4):
        got = run.get("checkpoint", r)
        assert int(got["frames2"]) == int(got["frames"]) == 32
        np.testing.assert_array_equal(got["a"], got["b"])
        assert tuple(got["single_v_shape"]) == (8, 5)
        assert int(got["n_out_pad"]) == 6
        if r % 2 == 1:                          # model rank 1: columns 3..5, the last padding
            assert not got["stripe"][:, -1:].any()
    # the mesh's file loads in the JAX package's single-chip Trainer
    rng = np.random.default_rng(1)
    P = [{"weight": (0.2 * rng.standard_normal((6, 8))).astype(np.float32),
          "bias": np.zeros(8, np.float32)}, {},
         {"weight": (0.2 * rng.standard_normal((8, 5))).astype(np.float32),
          "bias": np.zeros(5, np.float32)}, {}]
    jtr = JTrainer(Network((BiasedLinearity(6, 8), Sigmoid(8, 8), BiasedLinearity(8, 5),
                            Softmax(5, 5)), P),
                   JTrainerConfig(bunchsize=16, cachesize=32, randomize=False,
                                  sgd=SgdConfig(learning_rate=0.1, momentum=0.5)))
    jtr.load_state(str(out / "mesh_state.npz"))
    assert np.asarray(jtr.velocity[2]["weight"]).shape == (8, 5)
    assert jtr.stats.frames == 32


def _stdout_of(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue()


XENT = re.compile(r"Xent:(\S+) frames:(\d+) err/frm:\S+ correct\[(\S+)%\]")


@pytest.mark.parametrize("name", list(TNET))
def test_tnet_mesh_matches_jax_tnet_mesh(fleet4, corpus, tmp_path, name):
    """``tnet --MESH`` on 4 ranks against the JAX tnet's ``--MESH`` (same
    layout, 8 virtual devices) and the port's single-device tnet; rank 0
    alone writes the MMF; every rank prints the same global statistics."""
    run, out = fleet4
    extra = TNET[name]
    jmmf, smmf = tmp_path / "jax.mmf", tmp_path / "single.mmf"
    jlog = _stdout_of(jtnet.main, _tnet_argv(corpus, corpus / "init.mmf",
                                             f"--TARGETMMF={jmmf}", *extra))
    no_mesh = [e for e in extra if not e.startswith("--MESH")]
    _stdout_of(ttnet.main, _tnet_argv(corpus, corpus / "init.mmf", f"--TARGETMMF={smmf}",
                                      *no_mesh), device="cpu")
    logs = [str(run.get(name, r)["stdout"]) for r in range(4)]
    assert len({XENT.search(log).group(0) for log in logs}) == 1
    (tx, tf, tacc), (jx, jf, jacc) = [
        (float(m.group(1)), int(m.group(2)), float(m.group(3)))
        for m in (XENT.search(logs[0]), XENT.search(jlog))]
    assert tf == jf > 0
    np.testing.assert_allclose(tx, jx, rtol=1e-4)
    d, m = extra[0][len("--MESH="):].split("x")
    assert f"mesh=data:{d}xmodel:{m}" in logs[0]
    got = JNetwork.read(str(out / f"{name}.mmf")).params
    for a, b, c in zip(got, JNetwork.read(str(jmmf)).params, JNetwork.read(str(smmf)).params):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=5e-3, atol=1e-5)
            np.testing.assert_allclose(a[k], c[k], rtol=0, atol=1e-5)


def test_tnet_mesh_crossvalidate(fleet4, corpus):
    run, out = fleet4
    tlog = str(run.get("tnet_cv_2x2")["stdout"])
    assert "===== TNET CROSSVALIDATION STARTED =====" in tlog
    jlog = _stdout_of(jtnet.main, _tnet_argv(corpus, out / "tnet_2x2.mmf", "-c", "--MESH=2x2"))
    (tx, tf, tacc), (jx, jf, jacc) = [
        (float(m.group(1)), int(m.group(2)), float(m.group(3)))
        for m in (XENT.search(tlog), XENT.search(jlog))]
    assert tf == jf
    np.testing.assert_allclose(tx, jx, rtol=1e-5)
    assert abs(tacc - jacc) <= 100.0 / tf
