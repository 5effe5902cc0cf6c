"""The port's sharded step (``nnet_asr_torch/parallel/``) against the JAX
package's, on the CPU.

The port runs on a gloo fleet of 4 CPU ranks (``tests/torch_fleet.py``),
one launch for every case of this file; the JAX package runs the same
inputs (numpy, from a seed) through ``make_sharded_train_step`` on the
8-device virtual mesh of ``tests/conftest.py``, at the same (data, model)
layout. Tolerances are JAX's own (``tests/test_parallel.py``): 3e-4
relative for the step, 2e-2 / 3e-4 for bf16 / int8, the correct counts
equal and the Xent within 0.05. The port's mesh against its own
single-device Trainer is held tighter (1e-5 relative; 1e-6 for int8pfsr,
whose noise stream the port draws at the global bunch shape).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import torch_fleet as fleet
from nnet_asr_tpu.models import BiasedLinearity, BlockSoftmax, Network, Sigmoid, Softmax
from nnet_asr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nnet_asr_tpu.parallel.sharded_step import make_sharded_train_step as jax_step
from nnet_asr_tpu.parallel.sharded_step import zero_acc as jax_zero_acc
from nnet_asr_tpu.train.sgd import SgdConfig
from nnet_asr_torch.parallel.mesh import make_mesh, parse_mesh
from nnet_asr_torch.train.trainer import Trainer, TrainerConfig

SGD = dict(learning_rate=0.05, momentum=0.5, weightcost=1e-4)
LAYOUTS = [(4, 1), (2, 2), (1, 4)]

# name: case kwargs (torch_fleet.case_sharded_step)
CASES = {f"plain_{d}x{m}": dict(data=d, model=m, seed=0) for d, m in LAYOUTS}
CASES.update({f"padded_{d}x{m}": dict(data=d, model=m, seed=3, dout=21)
              for d, m in [(2, 2), (1, 4)]})
CASES.update({f"head_{h}_{o}": dict(data=2, model=2, seed=4, head=h, objective=o, dout=21,
                                    bunch=24)
              for h, o in [("blocksoftmax", "xent"), ("softmax", "mse"), ("bare", "mse")]})
CASES.update({f"dtype_{c}": dict(data=2, model=2, seed=7, compute_dtype=c,
                                 sgd_kw=dict(learning_rate=0.05, momentum=0.5))
              for c in ["bf16", "int8", "int8pf", "int8pfsr"]})
CASES["dtype_f32"] = dict(data=2, model=2, seed=7, sgd_kw=dict(learning_rate=0.05,
                                                                momentum=0.5))
CASES["eval_2x2"] = dict(data=2, model=2, seed=1, eval_only=True, bunch=16)


@pytest.fixture(scope="module")
def fleet_run(tmp_path_factory):
    cases = [(n, "sharded_step", kw) for n, kw in CASES.items()]
    cases.append(("int8full", "raises", dict(data=2, model=2, compute_dtype="int8full")))
    return fleet.run_fleet(tmp_path_factory.mktemp("fleet"), 4, cases)


def _jax_net(params, head):
    din, dh = params[0]["weight"].shape
    dout = params[2]["weight"].shape[1]
    specs = [BiasedLinearity(din, dh), Sigmoid(dh, dh), BiasedLinearity(dh, dout)]
    ps = [dict(p) for p in params]
    if head == "softmax":
        specs.append(Softmax(dout, dout))
    elif head == "blocksoftmax":
        specs.append(BlockSoftmax(dout, dout, dims=(8, 6, 7)))
    if head != "bare":
        ps.append({})
    return Network(tuple(specs), ps)


def _jax_run(kw):
    """The JAX mesh step over the case's bunches: (host params, acc)."""
    params, bunches = fleet.mlp_arrays(kw["seed"], dout=kw.get("dout", 24),
                                       bunch=kw.get("bunch", 32))
    head, objective = kw.get("head", "softmax"), kw.get("objective", "xent")
    mesh = jax_make_mesh(data=kw["data"], model=kw["model"])
    state, step, evalf, _ = jax_step(_jax_net(params, head), SgdConfig(**kw.get("sgd_kw", SGD)),
                                     mesh, objective=objective,
                                     compute_dtype=kw.get("compute_dtype"))
    state.to_device(mesh)
    acc = jax_zero_acc(objective)
    for X, labels in bunches:
        if kw.get("eval_only"):
            acc = evalf(state.params, acc, jnp.asarray(X), jnp.asarray(labels))
        else:
            state.params, state.velocity, acc = step(state.params, state.velocity, acc,
                                                     jnp.asarray(X), jnp.asarray(labels))
    return state.host_params(), {k: np.asarray(v) for k, v in acc.items()}


def _torch_single(kw):
    """The port's single-device Trainer over the case's bunches."""
    params, bunches = fleet.mlp_arrays(kw["seed"], dout=kw.get("dout", 24),
                                       bunch=kw.get("bunch", 32))
    net = fleet.torch_mlp(params, kw.get("head", "softmax"))
    tr = Trainer(net, TrainerConfig(objective=kw.get("objective", "xent"),
                                    compute_dtype=kw.get("compute_dtype"),
                                    sgd=fleet.sgd(**kw.get("sgd_kw", SGD))), device="cpu")
    for X, labels in bunches:
        tr._train_step(torch.from_numpy(X), torch.from_numpy(labels))
    return net.to_numpy_params()


def _assert_params(got, want, rtol, atol, what):
    for i in (0, 2):
        for k in ("weight", "bias"):
            np.testing.assert_allclose(got[f"p{i}.{k}"], np.asarray(want[i][k]), rtol=rtol,
                                       atol=atol, err_msg=f"{what}: layer {i} {k}")


@pytest.mark.parametrize("name", [f"plain_{d}x{m}" for d, m in LAYOUTS])
def test_sharded_matches_jax(fleet_run, name):
    kw = CASES[name]
    got = fleet_run.get(name)
    want, acc = _jax_run(kw)
    _assert_params(got, want, 3e-4, 1e-6, name)
    assert int(got["acc.correct"]) == int(acc["correct"])
    assert int(got["acc.frames"]) == int(acc["frames"]) == 96
    assert abs(float(got["acc.xent"]) - float(acc["xent"])) < 0.05
    # every rank holds the same replicated parameters
    for r in range(1, 4):
        other = fleet_run.get(name, r)
        for k in ("p0.weight", "p2.weight", "p2.bias"):
            np.testing.assert_array_equal(other[k], got[k])
    # the port's mesh against its own single device, tighter
    _assert_params(got, _torch_single(kw), 1e-5, 1e-7, name + " vs the port's Trainer")


@pytest.mark.parametrize("name", ["padded_2x2", "padded_1x4"])
def test_sharded_padded_senones(fleet_run, name):
    """21 senones over model=2 or 4: padded to 22 or 24, masked out of the
    softmax; the saved model is unpadded and the padding never moves."""
    kw = CASES[name]
    got = fleet_run.get(name)
    model = kw["model"]
    assert int(got["n_out_pad"]) == -(-21 // model) * model
    assert got["p2.weight"].shape == (32, 21)
    want, acc = _jax_run(kw)
    _assert_params(got, want, 3e-4, 1e-6, name)
    assert int(got["acc.correct"]) == int(acc["correct"])
    assert abs(float(got["acc.xent"]) - float(acc["xent"])) < 0.05
    last = fleet_run.get(name, model - 1)["stripe"]          # the last model rank's stripe
    n_pad = int(got["n_out_pad"]) - 21
    np.testing.assert_array_equal(last[:, last.shape[1] - n_pad:], 0.0)


@pytest.mark.parametrize("name", ["head_blocksoftmax_xent", "head_softmax_mse", "head_bare_mse"])
def test_sharded_gathered_heads(fleet_run, name):
    kw = CASES[name]
    got = fleet_run.get(name)
    want, acc = _jax_run(kw)
    _assert_params(got, want, 3e-4, 2e-6, name)
    if kw["objective"] == "xent":
        assert int(got["acc.correct"]) == int(acc["correct"])
        assert abs(float(got["acc.xent"]) - float(acc["xent"])) < 0.05
    else:
        assert abs(float(got["acc.mse"]) - float(acc["mse"])) < 0.05
    assert int(got["acc.frames"]) == int(acc["frames"])
    _assert_params(got, _torch_single(kw), 1e-5, 1e-7, name + " vs the port's Trainer")


@pytest.mark.parametrize("cdt,rtol", [("bf16", 2e-2), ("int8", 3e-4), ("int8pf", 3e-4)])
def test_sharded_compute_dtype_matches_jax(fleet_run, cdt, rtol):
    """bf16 and int8 on the mesh track the JAX mesh (the plain int8 scale is
    the global bunch's) and differ from the f32 run."""
    name = f"dtype_{cdt}"
    got = fleet_run.get(name)
    want, _ = _jax_run(CASES[name])
    _assert_params(got, want, rtol, rtol * 0.1, name)
    assert not np.allclose(got["p0.weight"], fleet_run.get("dtype_f32")["p0.weight"],
                           rtol=1e-7, atol=1e-9)


def test_sharded_int8pfsr_matches_the_single_device_stream(fleet_run):
    """int8pfsr's noise is drawn at the global bunch shape from the
    Trainer's generator and row-sliced: the mesh's trajectory is the
    port's single-device one (the JAX package's key stream is another)."""
    got = fleet_run.get("dtype_int8pfsr")
    _assert_params(got, _torch_single(CASES["dtype_int8pfsr"]), 1e-6, 1e-7, "int8pfsr")
    assert not np.allclose(got["p0.weight"], fleet_run.get("dtype_int8pf")["p0.weight"],
                           rtol=1e-7, atol=1e-9)


def test_sharded_compute_dtype_rejects_int8full(fleet_run):
    assert "int8full is single-chip-only" in str(fleet_run.get("int8full")["error"])


def test_sharded_eval(fleet_run):
    got = fleet_run.get("eval_2x2")
    want, acc = _jax_run(CASES["eval_2x2"])
    _assert_params(got, want, 0, 0, "eval leaves the parameters alone")
    assert int(got["acc.correct"]) == int(acc["correct"])
    assert int(got["acc.frames"]) == 48
    assert abs(float(got["acc.xent"]) - float(acc["xent"])) < 1e-2


@pytest.mark.parametrize("data,model,match", [
    (2, 1, "mesh 2x1 needs more than 1 devices"),
    (None, 3, "1 devices not divisible by model=3"),
    (1, 4, "mesh 1x4 needs more than 1 devices"),
])
def test_make_mesh_errors(data, model, match):
    """JAX make_mesh's ValueErrors, raised before any group forms (no
    launcher: a world of one rank)."""
    with pytest.raises(ValueError, match=match):
        make_mesh(data, model, device="cpu")


def test_parse_mesh():
    assert parse_mesh("4x2") == (4, 2)
    assert parse_mesh("2X1") == (2, 1)
    assert parse_mesh("8") == (8, 1)
