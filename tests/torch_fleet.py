"""A gloo fleet of CPU ranks for the port's multi-device tests.

``run_fleet(tmp_path, world, cases)`` starts ``world`` fresh interpreters
(``python tests/torch_fleet.py``), each a rank of one gloo group formed
through a ``file://`` rendezvous in ``tmp_path`` (no TCP port that two test
workers could both pick), with ``OMP_NUM_THREADS=1``. Every rank runs the
``cases`` in order: each is ``(name, function, kwargs)``, a function of
this module's ``CASES`` called as ``function(rank_ctx, **kwargs)``; what it
returns (a dict of numpy arrays, or None) is saved as
``<tmp_path>/<name>.r<rank>.npz``. A case that raises makes its rank exit
non-zero at once (its peers' next collective then fails); a fleet that
outlives ``timeout`` seconds is killed. Either fails the calling test.

The functions make their inputs from numpy seeds with the helpers below,
which the test files call too, to feed the same inputs to the JAX package
in the pytest process. This module imports torch and the port only.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


# ---------------------------------------------------------------------------
# launcher (pytest side)
# ---------------------------------------------------------------------------

class FleetResults:
    def __init__(self, outdir, logs):
        self.outdir = outdir
        self.logs = logs

    def get(self, name, rank=0):
        with np.load(os.path.join(self.outdir, f"{name}.r{rank}.npz"), allow_pickle=False) as f:
            return {k: f[k] for k in f.files}


def run_fleet(tmp_path, world, cases, timeout=240):
    """Run ``cases`` on a ``world``-rank gloo fleet; FleetResults."""
    outdir = str(tmp_path)
    spec = os.path.join(outdir, "fleet_cases.json")
    with open(spec, "w") as f:
        json.dump([[n, fn, kw] for n, fn, kw in cases], f)
    env = dict(os.environ)
    env.pop("PYTHONSTARTUP", None)
    env.update(PYTHONPATH=f"{REPO}:{HERE}", OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    for k in ("MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    rdv = "file://" + os.path.join(outdir, "fleet_rendezvous")
    procs = []
    for rank in range(world):
        env_r = dict(env, RANK=str(rank), LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_fleet.py"), rdv, outdir, spec],
            env=env_r, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=outdir))
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            logs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"fleet of {world} ranks outlived {timeout}s")
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, "ranks failed: " + "\n".join(
        f"--- rank {r} (exit {rc}) ---\n{logs[r][-4000:]}" for r, rc in bad)
    return FleetResults(outdir, logs)


# ---------------------------------------------------------------------------
# inputs shared by the ranks and the JAX side
# ---------------------------------------------------------------------------

def mlp_arrays(seed, din=16, dh=32, dout=24, n_bunches=3, bunch=32, n_labels=None):
    """(params as the JAX package holds them, [(X, labels)] bunches) of a
    din->dh->dout MLP: weights 0.1*N(0,1), zero biases, then the bunches."""
    rng = np.random.default_rng(seed)
    params = [{"weight": (0.1 * rng.standard_normal((din, dh))).astype(np.float32),
               "bias": np.zeros(dh, np.float32)}, {},
              {"weight": (0.1 * rng.standard_normal((dh, dout))).astype(np.float32),
               "bias": np.zeros(dout, np.float32)}]
    bunches = [(rng.standard_normal((bunch, din)).astype(np.float32),
                rng.integers(0, n_labels or dout, bunch).astype(np.int32))
               for _ in range(n_bunches)]
    return params, bunches


def head_layers(head, dout):
    """(port component of the head or None, its params) for 'softmax',
    'blocksoftmax' (dims 8/6/7 of 21 outputs) or 'bare'."""
    from nnet_asr_torch.models.components import BlockSoftmax, Softmax
    if head == "softmax":
        return Softmax(dout, dout)
    if head == "blocksoftmax":
        return BlockSoftmax(dout, dout, dims=(8, 6, 7))
    return None


def torch_mlp(params, head="softmax"):
    from nnet_asr_torch.models.components import BiasedLinearity, Sigmoid
    from nnet_asr_torch.models.network import Network
    din, dh = params[0]["weight"].shape
    dout = params[2]["weight"].shape[1]
    top = head_layers(head, dout)
    layers = [BiasedLinearity(din, dh), Sigmoid(dh, dh), BiasedLinearity(dh, dout)]
    ps = [dict(p) for p in params]
    if top is not None:
        layers.append(top)
        ps.append({})
    return Network(layers).from_numpy_params(ps)


def trainer_utts(seed, n=12, din=12, dout=15, lo=20, hi=50):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        T = int(rng.integers(lo, hi))
        out.append((rng.standard_normal((T, din)).astype(np.float32),
                    rng.integers(0, dout, T).astype(np.int32)))
    return out


def sgd(**kw):
    from nnet_asr_torch.train.sgd import SgdConfig
    return SgdConfig(**kw)


def host(params):
    """Flatten a list of param dicts into npz keys p{i}.{k}."""
    return {f"p{i}.{k}": np.asarray(v) for i, p in enumerate(params)
            for k, v in p.items() if isinstance(v, np.ndarray)}


def resident_corpus(tmp):
    """tests/test_resident.py's corpus (6 -> 8 -> 4; 10 training and 4 CV
    utterances of 30-70 frames), written by the port's host tools into the
    directory ``tmp`` (a pathlib.Path)."""
    from nnet_asr_torch.io import htk
    from nnet_asr_torch.io.mlf import MlfWriter
    from nnet_asr_torch.tools import gen_mlp_init
    rng = np.random.default_rng(0)
    dim, n_out = 6, 4
    (tmp / "phones.map").write_text("\n".join(f"p{i}" for i in range(n_out)))
    mlf = MlfWriter(str(tmp / "labels.mlf"))
    train_lines, cv_lines = [], []
    for u in range(14):
        T = int(rng.integers(30, 70))
        labels = rng.integers(0, n_out, T)
        feats = (np.eye(dim, dtype=np.float32)[labels % dim] * 2.0
                 + 0.3 * rng.standard_normal((T, dim)).astype(np.float32))
        p = str(tmp / f"u{u}.fea")
        htk.write_htk_file(p, feats, htk.PARMKIND_USER)
        mlf.write_record(f"*/u{u}.lab", [f"{t * 100000} {(t + 1) * 100000} p{l}"
                                         for t, l in enumerate(labels)])
        (train_lines if u < 10 else cv_lines).append(p)
    mlf.close()
    (tmp / "train.scp").write_text("\n".join(train_lines) + "\n")
    (tmp / "cv.scp").write_text("\n".join(cv_lines) + "\n")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        gen_mlp_init.main([f"--dim={dim}:8:{n_out}", "--gauss", "--negbias", "--seed=5"])
    (tmp / "init.mmf").write_text(buf.getvalue())
    return tmp


def scheduler_argv(tmp, weights_dir, *extra):
    """The scheduler's arguments on resident_corpus (tests/test_resident.py's)."""
    return ["--nn-init=" + str(tmp / "init.mmf"),
            "--mlf-train=" + str(tmp / "labels.mlf"),
            "--mlf-cv=" + str(tmp / "labels.mlf"),
            "--scp-train=" + str(tmp / "train.scp"),
            "--scp-cv=" + str(tmp / "cv.scp"),
            "--phonelist=" + str(tmp / "phones.map"),
            "--learnrate=8", "--bunchsize=32", "--cachesize=128",
            "--max-iter=3", "--momentum=0.4", "--weightcost=1e-5",
            "--weights-dir=" + str(weights_dir), *extra]


def phone_corpus(d):
    """tests/test_torch_tmpe.py's phone-structured corpus (4 phones x 3
    states, seeded phone lattices, gen_gmmbypass's HMM set) in ``d``."""
    from nnet_asr_torch.tools import gen_gmmbypass
    from nnet_asr_torch.tools.synth_corpus import CorpusShape, make_corpus, write_phone_lattices
    shape = CorpusShape(feat_dim=5, ext=2, dct=3, hidden=16, classes=12, phones=4,
                        n_train=4, n_cv=2, min_frames=30, max_frames=40)
    make_corpus(str(d), shape, seed=5)
    write_phone_lattices(str(d), seed=5)
    with contextlib.redirect_stdout(io.StringIO()):
        gen_gmmbypass.main([str(d / "map"), str(d / "hmms.mmf"), "--state-sep=_s"])
    return d


def tmpe_argv(d, *extra):
    return ["tmpe", "-H", str(d / "init.mmf"), "-I", str(d / "labs.mlf"), "-L", "*/",
            "-X", "lab", "-m", str(d / "map"), "-S", str(d / "train.scp"),
            "--HMM=" + str(d / "hmms.mmf"), "--LATTICEDIR=" + str(d / "lats"),
            "--FEATURETRANSFORM=" + str(d / "transform"), "--STARTFRMEXT=2",
            "--ENDFRMEXT=2", "--OUTPSCALE=0.3", "--MPEENGINE=native", *extra]


# ---------------------------------------------------------------------------
# cases (rank side)
# ---------------------------------------------------------------------------

def case_sharded_step(ctx, data, model, seed, head="softmax", objective="xent",
                      compute_dtype=None, dout=24, bunch=32, sgd_kw=None, eval_only=False):
    """make_sharded_train_step over mlp_arrays' bunches on a data x model
    mesh: the host params and the accumulated stats."""
    import torch
    from nnet_asr_torch.parallel.mesh import make_mesh
    from nnet_asr_torch.parallel.sharded_step import make_sharded_train_step, zero_acc

    params, bunches = mlp_arrays(seed, dout=dout, bunch=bunch)
    net = torch_mlp(params, head)
    mesh = make_mesh(data, model, device="cpu")
    cfg = sgd(**(sgd_kw or dict(learning_rate=0.05, momentum=0.5, weightcost=1e-4)))
    state, step, evalf, _ = make_sharded_train_step(net, cfg, mesh, objective=objective,
                                                    compute_dtype=compute_dtype)
    acc = zero_acc(objective)
    for X, labels in bunches:
        rows = mesh.rows(X.shape[0])
        f, lab = torch.from_numpy(X[rows]), torch.from_numpy(labels[rows])
        acc = evalf(acc, f, lab) if eval_only else step(acc, f, lab)
    out = host(state.host_params())
    out.update({f"acc.{k}": v.numpy() for k, v in acc.items()})
    out["n_out_pad"] = np.asarray(state.n_out_pad)
    w = state.params[state.out_idx]["weight"].detach().numpy()
    out["stripe"] = w
    return out


def case_raises(ctx, data, model, compute_dtype):
    """The text of the ValueError make_sharded_train_step raises."""
    from nnet_asr_torch.parallel.mesh import make_mesh
    from nnet_asr_torch.parallel.sharded_step import make_sharded_train_step
    params, _ = mlp_arrays(8)
    try:
        make_sharded_train_step(torch_mlp(params), sgd(), make_mesh(data, model, device="cpu"),
                                compute_dtype=compute_dtype)
    except ValueError as e:
        return {"error": np.asarray(str(e))}
    return {"error": np.asarray("")}


def case_tool(ctx, module, argv):
    """``nnet_asr_torch.tools.<module>.main(argv, device="cpu")``: its stdout."""
    import importlib
    mod = importlib.import_module(f"nnet_asr_torch.tools.{module}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv, device="cpu")
    return {"stdout": np.asarray(buf.getvalue()), "rc": np.asarray(rc)}


def trainer_cfg(**kw):
    from nnet_asr_torch.train.trainer import TrainerConfig
    base = dict(bunchsize=32, cachesize=128, seed=7, randomize=True,
                sgd=sgd(learning_rate=0.1, momentum=0.5))
    base.update(kw)
    return TrainerConfig(**base)


def case_sharded_trainer(ctx, data, model, crossvalidate=False):
    """A ShardedTrainer epoch over trainer_utts(0) (bunch 32, cache 128,
    seed 7, momentum 0.5): the unpadded params and the stats."""
    from nnet_asr_torch.parallel.mesh import make_mesh
    from nnet_asr_torch.parallel.sharded_trainer import ShardedTrainer
    params, _ = mlp_arrays(0, din=12, dh=24, dout=15, n_bunches=0)
    utts = trainer_utts(0, n=4 if crossvalidate else 12)
    cfg = trainer_cfg(randomize=not crossvalidate, crossvalidate=crossvalidate,
                      cachesize=64 if crossvalidate else 128)
    tr = ShardedTrainer(torch_mlp(params), cfg, make_mesh(data, model, device="cpu"))
    tr.run_epoch(iter(utts))
    out = host(tr.updated_network().to_numpy_params())
    out.update(frames=np.asarray(tr.stats.frames), corr=np.asarray(tr.stats.corr),
               xent=np.asarray(tr.stats.error), report=np.asarray(tr.throughput_report()))
    return out


def case_distributed_trainer(ctx, data, model):
    """tests/multihost_driver.py's run on the port: the ranks of data index
    d train on utterances [d::D] of its corpus with the negotiated intake."""
    import multihost_driver as drv
    from nnet_asr_torch.parallel.mesh import make_mesh
    from nnet_asr_torch.parallel.sharded_trainer import ShardedTrainer
    params, _ = mlp_arrays(3, din=12, dh=24, dout=15, n_bunches=0)
    mesh = make_mesh(data, model, device="cpu")
    cfg = trainer_cfg(sgd=sgd(learning_rate=0.1, momentum=0.5, weightcost=1e-4))
    tr = ShardedTrainer(torch_mlp(params), cfg, mesh, distributed=True)
    assert (tr.local_bunch, tr.local_cache) == (32 // data, 128 // data)
    tr.run_epoch(iter(drv.synth_corpus()[mesh.data_index::data]))
    out = host(tr.updated_network().to_numpy_params())
    out.update(frames=np.asarray(tr.stats.frames), corr=np.asarray(tr.stats.corr),
               xent=np.asarray(tr.stats.error), read=np.asarray(tr.total_frames))
    return out


def case_checkpoint(ctx, data, model):
    """tests/test_checkpoint.py's interop case on the port: a mesh state
    resumes on the mesh (continued training equal), loads in the
    single-device Trainer (unpadded), and a single-device state loads on
    the mesh (padding restored as zeros)."""
    import torch
    from nnet_asr_torch.models.components import BiasedLinearity, Sigmoid, Softmax
    from nnet_asr_torch.models.network import Network
    from nnet_asr_torch.parallel.mesh import make_mesh
    from nnet_asr_torch.parallel.sharded_trainer import ShardedTrainer
    from nnet_asr_torch.train.trainer import Trainer
    rng = np.random.default_rng(1)
    n_out = 5
    P = [{"weight": (0.2 * rng.standard_normal((6, 8))).astype(np.float32),
          "bias": np.zeros(8, np.float32)}, {},
         {"weight": (0.2 * rng.standard_normal((8, n_out))).astype(np.float32),
          "bias": np.zeros(n_out, np.float32)}, {}]

    def net():
        return Network([BiasedLinearity(6, 8), Sigmoid(8, 8), BiasedLinearity(8, n_out),
                        Softmax(n_out, n_out)]).from_numpy_params(P)

    cfg = trainer_cfg(bunchsize=16, cachesize=32, randomize=False)
    X = rng.standard_normal((32, 6)).astype(np.float32)
    y = rng.integers(0, n_out, 32).astype(np.int32)
    mesh = make_mesh(data, model, device="cpu")
    state = os.path.join(ctx.outdir, "mesh_state.npz")
    sh = ShardedTrainer(net(), cfg, mesh)
    sh.run_epoch(iter([(X, y)]))
    sh.save_state(state)
    sh2 = ShardedTrainer(net(), cfg, mesh)
    sh2.load_state(state)
    out = {"frames2": np.asarray(sh2.stats.frames), "frames": np.asarray(sh.stats.frames)}
    sh.run_epoch(iter([(X, y)]))
    sh2.run_epoch(iter([(X, y)]))
    out["a"] = sh.updated_network().to_numpy_params()[2]["weight"]
    out["b"] = sh2.updated_network().to_numpy_params()[2]["weight"]
    tr = Trainer(net(), cfg, device="cpu")
    tr.load_state(state)
    out["single_v_shape"] = np.asarray(tr.velocity[2]["weight"].shape)
    single = os.path.join(ctx.outdir, f"single_state.r{ctx.rank}.npz")
    tr.save_state(single)
    sh3 = ShardedTrainer(net(), cfg, mesh)
    sh3.load_state(single)
    out["stripe"] = sh3.params[2]["weight"].detach().numpy()
    out["n_out_pad"] = np.asarray(sh3.n_out_pad)
    torch.distributed.barrier()
    return out


def case_cd1(ctx, data, model, hid, vis, sparse, seed=0, steps=3, bunch=32):
    """Sharded CD-1 steps, the noise drawn at the global bunch shape from a
    generator seeded ``seed``: the params, the state and the last mse."""
    import torch
    from nnet_asr_torch.parallel.mesh import make_mesh
    from nnet_asr_torch.parallel.sharded_aux import make_sharded_cd1_step, place_cd1_inputs
    from nnet_asr_torch.train.rbm import RbmTrainConfig, init_rbm_state
    spec, params, bunches = rbm_arrays(seed, hid, vis, sparse, steps, bunch)
    mesh = make_mesh(data, model, device="cpu")
    cfg = RbmTrainConfig(learning_rate=0.1, momentum=0.5, weightcost=2e-4)
    step = make_sharded_cd1_step(spec, cfg, mesh)
    gen = torch.Generator().manual_seed(seed + 100)
    st0 = init_rbm_state(spec, {k: torch.from_numpy(v) for k, v in params.items()}, cfg)
    p, st, _ = place_cd1_inputs(mesh, params, {k: v.numpy() for k, v in st0.items()},
                                bunches[0])
    for X in bunches:
        mse = step(p, st, torch.from_numpy(X[mesh.rows(X.shape[0])]), generator=gen)
    out = {f"p.{k}": v.numpy() for k, v in p.items()}
    out.update({f"s.{k}": v.numpy() for k, v in st.items()})
    out["mse"] = mse.numpy()
    return out


def rbm_arrays(seed, hid, vis, sparse, steps, bunch, n_vis=24, n_hid=32):
    """(port spec, params, bunches) of tests/test_parallel_aux.py's RBM."""
    from nnet_asr_torch.models.components import Rbm, RbmSparse
    rng = np.random.default_rng(seed)
    spec = (RbmSparse if sparse else Rbm)(n_vis, n_hid, vis_type=vis, hid_type=hid)
    params = {"weight": (0.1 * rng.standard_normal((n_vis, n_hid))).astype(np.float32),
              "vis_bias": np.zeros(n_vis, np.float32),
              "hid_bias": np.zeros(n_hid, np.float32)}
    bunches = [rng.standard_normal((bunch, n_vis)).astype(np.float32) for _ in range(steps)]
    return spec, params, bunches


def case_mpe(ctx, data, model, seed=1, steps=3, rows=48):
    """The sharded MPE forward (gathered log posteriors) and update over
    mpe_arrays' frames and errors."""
    import torch
    from nnet_asr_torch.parallel.mesh import make_mesh
    from nnet_asr_torch.parallel.sharded_aux import make_sharded_mpe_step
    from nnet_asr_torch.train.sgd import init_momentum
    params, frames = mpe_arrays(seed, steps, rows)
    mesh = make_mesh(data, model, device="cpu")
    net = torch_mlp(params)
    cfg = sgd(learning_rate=0.05, weightcost=1e-4)
    fwd, upd = make_sharded_mpe_step(net, cfg, mesh)
    vel = init_momentum(net, cfg.momentum)
    out = {}
    for i, (feats, err) in enumerate(frames):
        r = mesh.rows(feats.shape[0])
        out[f"logpost{i}"] = fwd(torch.from_numpy(feats[r])).numpy()
        upd(vel, torch.from_numpy(feats[r]), torch.from_numpy(err[r]), 40)
    out.update(host(net.to_numpy_params()))
    return out


def mpe_arrays(seed, steps=3, rows=48):
    params, _ = mlp_arrays(seed, n_bunches=0)
    rng = np.random.default_rng(seed + 50)
    frames = [(rng.standard_normal((rows, 16)).astype(np.float32),
               (0.1 * rng.standard_normal((rows, 24))).astype(np.float32))
              for _ in range(steps)]
    return params, frames


def recurrent_arrays(seed, n_utts, din=8, dr=12, dout=5):
    """tests/test_parallel_aux.py's recurrent net (params) and utterances."""
    rng = np.random.default_rng(seed)
    params = [{"weight": (0.3 * rng.standard_normal((din, dr))).astype(np.float32),
               "bias": np.zeros(dr, np.float32)}, {},
              {"weight": (0.3 * rng.standard_normal((2 * dr, dr))).astype(np.float32),
               "bias": np.zeros(dr, np.float32)},
              {"weight": (0.3 * rng.standard_normal((dr, dout))).astype(np.float32),
               "bias": np.zeros(dout, np.float32)}, {}]
    feats = [rng.standard_normal((t, din)).astype(np.float32)
             for t in rng.integers(10, 30, n_utts)]
    labels = [rng.integers(0, dout, f.shape[0]).astype(np.int32) for f in feats]
    return params, feats, labels


def torch_recurrent(params):
    from nnet_asr_torch.models.components import BiasedLinearity, Recurrent, Sigmoid, Softmax
    from nnet_asr_torch.models.network import Network
    din, dr = params[0]["weight"].shape
    dout = params[3]["weight"].shape[1]
    return Network([BiasedLinearity(din, dr), Sigmoid(dr, dr), Recurrent(dr, dr),
                    BiasedLinearity(dr, dout), Softmax(dout, dout)]).from_numpy_params(params)


RECURRENT_SGD = dict(learning_rate=0.1, momentum=0.5, weightcost=1e-4)


def case_recurrent(ctx, data, model, n_utts, seed=3, crossvalidate=False):
    """One RecurrentTrainer batch (BPTT order 3) on the mesh."""
    from nnet_asr_torch.parallel.mesh import make_mesh
    from nnet_asr_torch.train.recurrent import RecurrentTrainer, RecurrentTrainerConfig
    params, feats, labels = recurrent_arrays(seed, n_utts)
    cfg = RecurrentTrainerConfig(bptt_order=3, crossvalidate=crossvalidate,
                                 sgd=sgd(**RECURRENT_SGD))
    tr = RecurrentTrainer(torch_recurrent(params), cfg, mesh=make_mesh(data, model, device="cpu"))
    tr.train_batch(feats, labels)
    out = host(tr.net.to_numpy_params())
    out.update(frames=np.asarray(tr.stats.frames), corr=np.asarray(tr.stats.corr),
               xent=np.asarray(tr.stats.error))
    return out


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


# ---------------------------------------------------------------------------
# rank entry point
# ---------------------------------------------------------------------------

class RankContext:
    def __init__(self, rank, world, outdir):
        self.rank, self.world, self.outdir = rank, world, outdir


def _rank_main(rdv, outdir, spec):
    import torch

    from nnet_asr_torch.parallel import mesh as mesh_mod

    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    mesh_mod.init_process_group(torch.device("cpu"), init_method=rdv,
                                timeout=mesh_mod.timedelta(seconds=120))
    ctx = RankContext(rank, world, outdir)
    with open(spec) as f:
        cases = json.load(f)
    for name, fn, kw in cases:
        out = CASES[fn](ctx, **kw)
        if out is not None:
            np.savez(os.path.join(outdir, f"{name}.r{rank}.npz"), **out)
        print(f"rank {rank}: {name} done", flush=True)


if __name__ == "__main__":
    try:
        _rank_main(*sys.argv[1:4])
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    sys.stdout.flush()
    os._exit(0)
