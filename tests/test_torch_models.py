"""The port's components and Network against the JAX package's, on the CPU.

Same numpy inputs through ``spec.apply`` / ``jax.vjp`` and the port's
``apply`` / autograd: forward and input gradient within rtol 1e-6,
atol 1e-6 (f32, summation order only). MMF text must be byte-equal.
Parameters in the JAX nesting (lists of block matrices, BlockArray's list
of sub-network dicts) cross as numpy arrays.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnet_asr_tpu.models import components as JC
from nnet_asr_tpu.models.network import Network as JNetwork
from nnet_asr_tpu.tools import gen_mlp_init, generators
from nnet_asr_torch.models import components as TC
from nnet_asr_torch.models.network import Network as TNetwork

torch.set_num_threads(2)

RTOL = ATOL = 1e-6


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _jx(p):
    """numpy params (any nesting) → jnp arrays."""
    return jax.tree_util.tree_map(jnp.asarray, p)


def _tx(p):
    """numpy params (any nesting) → torch tensors."""
    return jax.tree_util.tree_map(torch.from_numpy, p)


def _cluster_params(rng, din, dout, k):
    return {"cluster_weights": [_rand(rng, din, din) for _ in range(k)],
            "cluster_biases": [_rand(rng, din) for _ in range(k)],
            "const_weight": _rand(rng, din, dout), "const_bias": _rand(rng, dout),
            "weight": _rand(rng, din, dout), "bias": _rand(rng, dout)}


def _case(name, rng):
    """(jax spec, torch component, numpy params, input rows, input dim)."""
    if name == "biasedlinearity":
        p = {"weight": _rand(rng, 7, 5), "bias": _rand(rng, 5)}
        return JC.BiasedLinearity(7, 5), TC.BiasedLinearity(7, 5), p, 9, 7
    if name == "sharedlinearity":
        p = {"weight": _rand(rng, 4, 3), "bias": _rand(rng, 3)}
        return (JC.SharedLinearity(8, 6, n_instances=2),
                TC.SharedLinearity(8, 6, n_instances=2), p, 9, 8)
    if name == "sigmoid":
        return JC.Sigmoid(6, 6), TC.Sigmoid(6, 6), {}, 9, 6
    if name == "softmax":
        return JC.Softmax(6, 6), TC.Softmax(6, 6), {}, 9, 6
    if name == "expand":
        offs = (-2, -1, 0, 1, 2)
        return JC.Expand(3, 15, offsets=offs), TC.Expand(3, 15, offsets=offs), {}, 9, 3
    if name == "expand_clamped":
        # offsets beyond the 3 rows on both sides: every block clamps
        offs = (-4, 0, 5)
        return JC.Expand(2, 6, offsets=offs), TC.Expand(2, 6, offsets=offs), {}, 3, 2
    if name == "copy":
        idx = (0, 2, 4, 4, 1, 3, 0)
        return JC.Copy(5, 7, indices=idx), TC.Copy(5, 7, indices=idx), {}, 9, 5
    if name == "transpose":
        return JC.Transpose(12, 12, context=3), TC.Transpose(12, 12, context=3), {}, 9, 12
    if name == "blocklinearity":
        p = {"block": _rand(rng, 3, 2)}
        return (JC.BlockLinearity(12, 8, block_in=3, block_out=2),
                TC.BlockLinearity(12, 8, block_in=3, block_out=2), p, 9, 12)
    if name == "bias":
        return JC.Bias(6, 6), TC.Bias(6, 6), {"bias": _rand(rng, 6)}, 9, 6
    if name == "window":
        return JC.Window(6, 6), TC.Window(6, 6), {"window": _rand(rng, 6)}, 9, 6
    if name == "log":
        return JC.Log(6, 6), TC.Log(6, 6), {}, 9, 6
    if name == "blocksoftmax":
        return (JC.BlockSoftmax(7, 7, dims=(3, 4)), TC.BlockSoftmax(7, 7, dims=(3, 4)),
                {}, 9, 7)
    if name == "sparselinearity":
        p = {"weight": _rand(rng, 7, 5), "bias": _rand(rng, 5),
             "mask": (rng.random((7, 5)) > 0.3).astype(np.float32)}
        return JC.SparseLinearity(7, 5), TC.SparseLinearity(7, 5), p, 9, 7
    if name == "clusterlinearity":
        cmap = ((1, 3), (2,))
        return (JC.ClusterLinearity(6, 4, n_instances=2, cluster_map=cmap),
                TC.ClusterLinearity(6, 4, cluster_map=cmap), _cluster_params(rng, 6, 4, 2), 9, 6)
    if name == "discretelinearity":
        dims = ((3, 2), (4, 5))
        p = {"weights": [_rand(rng, *d) for d in dims], "bias": _rand(rng, 7)}
        return (JC.DiscreteLinearity(7, 7, block_dims=dims),
                TC.DiscreteLinearity(7, 7, block_dims=dims), p, 9, 7)
    if name in ("rbm", "rbm_gauss", "rbmsparse"):
        p = {"weight": _rand(rng, 6, 4), "vis_bias": _rand(rng, 6), "hid_bias": _rand(rng, 4)}
        units = ("gauss", "gauss") if name == "rbm_gauss" else ("bern", "bern")
        j, t = (JC.RbmSparse, TC.RbmSparse) if name == "rbmsparse" else (JC.Rbm, TC.Rbm)
        kw = dict(vis_type=units[0], hid_type=units[1])
        return j(6, 4, **kw), t(6, 4, **kw), p, 9, 6
    if name == "recurrent":
        p = {"weight": 0.5 * _rand(rng, 5 + 4, 4), "bias": _rand(rng, 4)}
        return JC.Recurrent(5, 4), TC.Recurrent(5, 4), p, 9, 5
    if name == "blockarray":
        # two blocks over 4 input columns each: affine + sigmoid, and an
        # affine alone
        p = {"blocks": [[{"weight": _rand(rng, 4, 3), "bias": _rand(rng, 3)}, {}],
                        [{"weight": _rand(rng, 4, 2), "bias": _rand(rng, 2)}]]}
        jsub = ((JC.BiasedLinearity(4, 3), JC.Sigmoid(3, 3)), (JC.BiasedLinearity(4, 2),))
        tsub = [[TC.BiasedLinearity(4, 3), TC.Sigmoid(3, 3)], [TC.BiasedLinearity(4, 2)]]
        return JC.BlockArray(8, 5, subnets=jsub), TC.BlockArray(8, 5, tsub), p, 9, 8
    raise KeyError(name)


TAGS = ["biasedlinearity", "sharedlinearity", "sigmoid", "softmax", "expand",
        "expand_clamped", "copy", "transpose", "blocklinearity", "bias", "window",
        "log", "blocksoftmax", "sparselinearity", "clusterlinearity", "discretelinearity",
        "rbm", "rbm_gauss", "rbmsparse", "recurrent", "blockarray"]


@pytest.mark.parametrize("name", TAGS)
def test_component_forward_and_input_grad_match_jax(name):
    rng = np.random.default_rng(TAGS.index(name))
    jspec, tcomp, p, rows, din = _case(name, rng)
    tcomp.load_params(p)
    x = _rand(rng, rows, din)
    if name == "log":
        x = np.abs(x) + 0.1
    jy, vjp = jax.vjp(lambda xx: jspec.apply(_jx(p), xx), jnp.asarray(x))
    g = _rand(rng, *jy.shape)
    (jdx,) = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_(True)
    ty = tcomp(xt)
    ty.backward(torch.from_numpy(g))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), rtol=RTOL, atol=ATOL)
    # the functional form agrees with the module form
    ty2 = tcomp.apply(_tx(p), torch.from_numpy(x))
    np.testing.assert_array_equal(ty2.numpy(), ty.detach().numpy())


# the port's text of each tag (written from JAX's text of the same params,
# and read back from its own) is byte-equal to JAX's
@pytest.mark.parametrize("name", TAGS)
def test_component_mmf_text_byte_equal_to_jax(name):
    jspec, _, p, _, _ = _case(name, np.random.default_rng(100 + TAGS.index(name)))
    text = JNetwork((jspec,), [_jx(p)]).to_text()
    jtext = JNetwork.read(text).to_text()
    tnet = TNetwork.read(text)
    assert tnet.to_text() == jtext
    assert TNetwork.read(tnet.to_text()).to_text() == jtext
    assert [l.tag for l in tnet.layers] == [jspec.tag]


def _mat(rng, r, c, scale=1.0):
    return f"m {r} {c}\n" + "\n".join(" ".join(repr(float(v)) for v in row)
                                      for row in scale * rng.standard_normal((r, c))) + "\n"


# SparseLinearity on read: a missing mask is all ones, the accumulator
# matrix after the mask is skipped; on write the mask is pruned at
# |w| < 1e-3 (and the weight kept), as JAX writes it
@pytest.mark.parametrize("mask", ["none", "mask", "mask_and_accu"])
def test_sparselinearity_read_and_prune_on_write_match_jax(mask):
    rng = np.random.default_rng(21)
    body = _mat(rng, 5, 7, scale=2e-3) + "v 5\n" + " ".join(["0.5"] * 5) + "\n"
    if mask != "none":
        body += _mat(rng, 5, 7).replace("-", "")      # a mask of non-zeros
    if mask == "mask_and_accu":
        body += _mat(rng, 5, 7)
    text = f"<sparselinearity> 5 7\n{body}<sigmoid> 5 5\n"
    jnet, tnet = JNetwork.read(text), TNetwork.read(text)
    assert tnet.to_text() == jnet.to_text()
    written = TNetwork.read(tnet.to_text()).layers[0]
    w = tnet.layers[0].weight.detach().numpy()
    assert 0 < (np.abs(w) < 1e-3).sum() < w.size
    np.testing.assert_array_equal(written.mask.numpy()[np.abs(w) < 1e-3], 0.0)
    np.testing.assert_array_equal(written.weight.detach().numpy(), w)
    if mask == "none":
        np.testing.assert_array_equal(tnet.layers[0].mask.numpy(), 1.0)


def test_sparselinearity_update_mask_and_rbm_reconstruct_match_jax():
    rng = np.random.default_rng(22)
    _, _, p, _, _ = _case("sparselinearity", rng)
    p["weight"][0, :3] = [5e-4, -2e-4, 0.0]
    want = JC.SparseLinearity.update_mask(_jx(p), threshold=1e-3)
    got = TC.SparseLinearity.update_mask(_tx(p), threshold=1e-3)
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    assert got["mask"][0, :3].sum() == 0
    for units in (("bern", "bern"), ("gauss", "gauss")):
        kw = dict(vis_type=units[0], hid_type=units[1])
        jspec, tspec = JC.Rbm(6, 4, **kw), TC.Rbm(6, 4, **kw)
        _, _, rp, _, _ = _case("rbm", rng)
        h = _rand(rng, 5, 4)
        np.testing.assert_allclose(tspec.reconstruct(_tx(rp), torch.from_numpy(h)).numpy(),
                                   np.asarray(jspec.reconstruct(_jx(rp), jnp.asarray(h))),
                                   rtol=RTOL, atol=ATOL)


def _stdout_of(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


def _mmf_texts():
    mlp = _stdout_of(gen_mlp_init.main,
                     ["--dim=12:16:8:5", "--gauss", "--negbias", "--seed=3"])
    hamm = _stdout_of(generators.main, ["hamm_dct", "--dimIn=4", "--startFrmExt=2",
                                        "--endFrmExt=2", "--dctBaseCnt=3"])
    rng = np.random.default_rng(11)
    d = 4 * 3
    norm = (f"<bias> {d} {d}\nv {d}\n" + " ".join(repr(float(v)) for v in rng.standard_normal(d))
            + f"\n<window> {d} {d}\nv {d}\n"
            + " ".join(repr(float(v)) for v in rng.random(d) + 0.5) + "\n")
    shared = _stdout_of(generators.main, ["sharedlinearity_init", "--dim=8:6",
                                          "--inst=2", "--gauss", "--seed=5"])
    copy = "<copy> 5 4\nv 5\n1 3 2 4 4\n"
    return {"gen_mlp_init": mlp, "hamm_dct": hamm, "hamm_dct_norm": hamm + norm,
            "sharedlinearity": shared, "copy": copy}


@pytest.mark.parametrize("which", ["gen_mlp_init", "hamm_dct", "hamm_dct_norm",
                                   "sharedlinearity", "copy"])
def test_mmf_text_byte_equal_to_jax(which):
    text = _mmf_texts()[which]
    jnet = JNetwork.read(text)
    tnet = TNetwork.read(text)
    assert tnet.to_text() == jnet.to_text()
    assert (tnet.n_inputs, tnet.n_outputs) == (jnet.n_inputs, jnet.n_outputs)
    tnet.check_dims()
    # and the port reads its own output back unchanged
    assert TNetwork.read(tnet.to_text()).to_text() == jnet.to_text()


@pytest.mark.parametrize("which", ["gen_mlp_init", "hamm_dct_norm"])
def test_network_apply_matches_jax(which):
    text = _mmf_texts()[which]
    jnet = JNetwork.read(text)
    tnet = TNetwork.read(text)
    rng = np.random.default_rng(12)
    x = _rand(rng, 10, jnet.n_inputs)
    want = np.asarray(jnet.apply(jnet.params, jnp.asarray(x)))
    got = tnet.apply(tnet.params, torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tnet(torch.from_numpy(x)).detach().numpy(), got)


def test_numpy_params_round_trip():
    text = _mmf_texts()["gen_mlp_init"]
    jnet = JNetwork.read(text)
    rng = np.random.default_rng(13)
    new = [{k: _rand(rng, *np.shape(v)) for k, v in p.items()} for p in jnet.params]
    tnet = TNetwork.read(text).from_numpy_params(new)
    back = tnet.to_numpy_params()
    assert [sorted(p) for p in back] == [sorted(p) for p in new]
    for a, b in zip(back, new):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    jtext = JNetwork(jnet.specs, new).to_text()
    assert tnet.to_text() == jtext
    with pytest.raises(ValueError):
        tnet.from_numpy_params(new[:-1])
    bad = [dict(p) for p in new]
    bad[0] = {"weight": np.zeros((3, 3), np.float32), "bias": new[0]["bias"]}
    with pytest.raises(ValueError):
        tnet.from_numpy_params(bad)


# the JAX package's checks on malformed files, with its messages
@pytest.mark.parametrize("text,match", [
    ("<blocksoftmax> 5 5\nv 2\n2 2\n", "Non-matching dimension of sum of softmaxes"),
    ("<rbm> 2 2\nbern poisson\n", "Invalid unit type"),
    ("<blockarray> 2 2\n1\n<block> 2\n", "Expected '<block> 1'"),
    ("<clusterlinearity> 2 2\n1\nx 1 1\n", "Bad cluster xform header"),
    ("<discretelinearity> 2 2\n0\n", "Bad number of blocks"),
])
def test_malformed_new_tags_raise_as_jax(text, match):
    for read in (JNetwork.read, TNetwork.read):
        with pytest.raises(ValueError, match=match):
            read(text)


# nested parameters cross in the JAX nesting: the port's tensors hold the
# numpy arrays exactly, JAX writes the same text from what the port hands
# back, trainable entries are Parameters and the rest buffers
@pytest.mark.parametrize("name", ["discretelinearity", "clusterlinearity", "blockarray",
                                  "sparselinearity", "rbm"])
def test_nested_params_round_trip(name):
    rng = np.random.default_rng(30 + len(name))
    jspec, tcomp, p, _, _ = _case(name, rng)
    tnet = TNetwork([tcomp]).from_numpy_params([p])
    back = tnet.to_numpy_params()
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure([p])
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves([p])):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert JNetwork((jspec,), back).to_text() == tnet.to_text()
    n_params = sum(t.numel() for t in tnet.parameters())
    if name != "blockarray":    # (its sub-layers keep their own Parameters)
        assert n_params == sum(np.size(v) for k, v in p.items() if k in jspec.trainable_keys
                               for v in jax.tree_util.tree_leaves(v))
    assert n_params + sum(t.numel() for t in tnet.buffers()) == sum(
        np.size(v) for v in jax.tree_util.tree_leaves(p))
    bad = jax.tree_util.tree_map(lambda a: np.zeros(a.shape[:-1] + (a.shape[-1] + 1,),
                                                    np.float32), p)
    if jax.tree_util.tree_leaves(bad):
        with pytest.raises(ValueError):
            tnet.from_numpy_params([bad])


# halo-streamed forward over T > max_frames with an <expand> in the net:
# equal to JAX's (rtol 1e-5, atol 1e-6) and to the whole-utterance forward
@pytest.mark.parametrize("T,block", [(50, 16), (41, 8)])
def test_feedforward_matches_jax(T, block):
    rng = np.random.default_rng(40 + T)
    ext = 2
    w = 0.3 * rng.standard_normal((12, 4 * (2 * ext + 1)))
    text = (_stdout_of(generators.main, ["splice", "--dimIn=4", f"--startFrmExt={ext}",
                                         f"--endFrmExt={ext}"])
            + f"<biasedlinearity> 12 20\nm 12 20\n"
            + "\n".join(" ".join(repr(float(v)) for v in row) for row in w)
            + "\nv 12\n" + " ".join(["0.1"] * 12) + "\n<sigmoid> 12 12\n")
    jnet, tnet = JNetwork.read(text), TNetwork.read(text)
    x = _rand(rng, T, 4)
    kw = dict(start_frm_ext=ext, end_frm_ext=ext, max_frames=20, block=block)
    want = np.asarray(jnet.feedforward(jnp.asarray(x), **kw))
    got = tnet.feedforward(torch.from_numpy(x), **kw).detach().numpy()
    assert got.shape == want.shape == (T, 12)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, tnet(torch.from_numpy(x)).detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        tnet.feedforward(torch.from_numpy(x[:20]), **kw).detach().numpy(),
        tnet(torch.from_numpy(x[:20])).detach().numpy())
    np.testing.assert_allclose(
        tnet.apply_upto(tnet.params, torch.from_numpy(x), 2).detach().numpy(),
        np.asarray(jnet.apply_upto(jnet.params, jnp.asarray(x), 2)), rtol=1e-5, atol=1e-6)
    assert tnet.has_recurrent() is jnet.has_recurrent() is False


def test_unknown_tag_raises_value_error():
    with pytest.raises(ValueError, match="Unknown Component tag"):
        TNetwork.read("<nosuchtag> 3 3\n")
