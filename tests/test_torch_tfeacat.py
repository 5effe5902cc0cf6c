"""The port's tfeacat and tnorm against the JAX tools, on the CPU.

Same synthetic corpus (``nnet_asr_torch.tools.synth_corpus`` at a small
shape), transform and model. Posteriors and log-posteriors agree within
f32 GEMM summation order (rtol 1e-5, atol 1e-6 and atol 1e-5); the
GMM-bypass features within atol 1e-5 (the model's posteriors stay far from
1, where ``sqrt(-2 log p)`` is steep); tnorm's bias and window within
rtol 1e-5, atol 1e-7 (float64 sums of f32 rows; the normalised
transform's mean is a near-zero sum, held in absolute terms). ``--BF16``
and ``--INT8`` hold to the tolerances stated at their test.
"""

import numpy as np
import pytest
import torch

from nnet_asr_tpu.io import htk
from nnet_asr_tpu.models.network import Network as JNetwork
from nnet_asr_tpu.tools import tfeacat as jtfeacat
from nnet_asr_tpu.tools import tnorm as jtnorm
from nnet_asr_torch.models.network import Network as TNetwork
from nnet_asr_torch.tools import tfeacat as ttfeacat
from nnet_asr_torch.tools import tnorm as ttnorm
from nnet_asr_torch.tools.synth_corpus import CorpusShape, make_corpus

torch.set_num_threads(2)

SHAPE = CorpusShape(feat_dim=5, ext=3, dct=4, hidden=24, classes=6, n_train=6,
                    n_cv=20, min_frames=20, max_frames=40)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    n = make_corpus(str(d), SHAPE, seed=31)
    assert n["cv"] > 0
    return d


def _tfeacat_argv(d, out, *extra):
    return ["tfeacat", "-H", str(d / "init.mmf"), "-S", str(d / "cv.scp"),
            f"--FEATURETRANSFORM={d / 'transform'}", f"--STARTFRMEXT={SHAPE.ext}",
            f"--ENDFRMEXT={SHAPE.ext}", "-l", str(out), "-y", "post", *extra]


TOL = {"posterior": dict(rtol=1e-5, atol=1e-6), "log": dict(rtol=0, atol=1e-5),
       "gmmbypass": dict(rtol=0, atol=1e-5)}


@pytest.mark.parametrize("mode,extra", [
    ("posterior", ()), ("log", ("--LOGPOSTERIOR=TRUE",)), ("gmmbypass", ("--GMMBYPASS=TRUE",)),
])
def test_tfeacat_matches_jax(corpus, tmp_path, mode, extra):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()
    assert jtfeacat.main(_tfeacat_argv(corpus, jdir, *extra)) == 0
    assert ttfeacat.main(_tfeacat_argv(corpus, tdir, *extra), device="cpu") == 0
    names = sorted(p.name for p in jdir.iterdir())
    assert len(names) == SHAPE.n_cv and names == sorted(p.name for p in tdir.iterdir())
    for name in names:
        (j, jh), (t, th) = (htk.read_htk_file(str(p / name)) for p in (jdir, tdir))
        assert th == jh and th.sample_kind == htk.PARMKIND_USER
        assert t.shape == j.shape and t.shape[1] == SHAPE.classes
        assert np.isfinite(t).all()
        np.testing.assert_allclose(t, j, **TOL[mode])
        if mode == "posterior":
            np.testing.assert_allclose(t.sum(1), 1.0, rtol=1e-5)


def _new_tags_model(d):
    """A model over the transform's 20 outputs through every tag the port
    gained with TNet's full network vocabulary: BlockArray (two affine +
    sigmoid blocks), DiscreteLinearity, Rbm, Log, SparseLinearity with a
    pruned mask, RbmSparse (Gaussian), ClusterLinearity and a BlockSoftmax
    head; written by the JAX package from seeded numpy params."""
    from nnet_asr_tpu.models import components as JC

    rng = np.random.default_rng(33)
    din = SHAPE.feat_dim * SHAPE.dct

    def r(*shape):
        return (0.4 * rng.standard_normal(shape)).astype(np.float32)

    bl = JC.BiasedLinearity
    specs = (
        JC.BlockArray(din, 16, subnets=((bl(din // 2, 8), JC.Sigmoid(8, 8)),
                                        (bl(din // 2, 8), JC.Sigmoid(8, 8)))),
        JC.DiscreteLinearity(16, 16, block_dims=((8, 6), (8, 10))),
        JC.Sigmoid(16, 16),
        JC.Rbm(16, 12, vis_type="bern", hid_type="bern"),
        JC.Log(12, 12),
        JC.SparseLinearity(12, 10),
        JC.RbmSparse(10, 10, vis_type="gauss", hid_type="gauss"),
        JC.ClusterLinearity(10, SHAPE.classes, n_instances=2, cluster_map=((1, 2), (3,))),
        JC.BlockSoftmax(SHAPE.classes, SHAPE.classes, dims=(2, SHAPE.classes - 2)),
    )
    params = [
        {"blocks": [[{"weight": r(din // 2, 8), "bias": r(8)}, {}] for _ in range(2)]},
        {"weights": [r(8, 6), r(8, 10)], "bias": r(16)},
        {},
        {"weight": r(16, 12), "vis_bias": r(16), "hid_bias": r(12)},
        {},
        {"weight": r(12, 10), "bias": r(10),
         "mask": (rng.random((12, 10)) > 0.2).astype(np.float32)},
        {"weight": r(10, 10), "vis_bias": r(10), "hid_bias": r(10)},
        {"cluster_weights": [r(10, 10), r(10, 10)], "cluster_biases": [r(10), r(10)],
         "const_weight": r(10, SHAPE.classes), "const_bias": r(SHAPE.classes),
         "weight": r(10, SHAPE.classes), "bias": r(SHAPE.classes)},
        {},
    ]
    path = d / "new_tags.mmf"
    path.write_text(JNetwork(specs, params).to_text())
    return path


# posteriors of the model with the new tags within rtol 1e-5, atol 1e-6
# (f32 summation order), and the stacked network's text byte-equal
def test_tfeacat_new_tags_matches_jax(corpus, tmp_path):
    model = _new_tags_model(tmp_path)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()
    argv = [a if a != str(corpus / "init.mmf") else str(model)
            for a in _tfeacat_argv(corpus, jdir)]
    assert jtfeacat.main(argv) == 0
    assert ttfeacat.main([a if a != str(jdir) else str(tdir) for a in argv], device="cpu") == 0
    names = sorted(p.name for p in jdir.iterdir())
    assert len(names) == SHAPE.n_cv and names == sorted(p.name for p in tdir.iterdir())
    for name in names:
        (j, jh), (t, th) = (htk.read_htk_file(str(p / name)) for p in (jdir, tdir))
        assert th == jh and t.shape == j.shape and t.shape[1] == SHAPE.classes
        assert np.isfinite(t).all()
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(t[:, :2].sum(1), 1.0, rtol=1e-5)
    transform = (corpus / "transform").read_text()
    j = jtfeacat.combine_networks(JNetwork.read(transform), JNetwork.read(str(model)))
    t = ttfeacat.combine_networks(TNetwork.read(transform), TNetwork.read(str(model)))
    assert t.to_text() == j.to_text()


def test_combine_networks_matches_jax(corpus):
    transform, net = (corpus / "transform").read_text(), (corpus / "init.mmf").read_text()
    j = jtfeacat.combine_networks(JNetwork.read(transform), JNetwork.read(net))
    t = ttfeacat.combine_networks(TNetwork.read(transform), TNetwork.read(net))
    assert t.to_text() == j.to_text()
    assert (ttfeacat.combine_networks(None, TNetwork.read(net)).to_text()
            == TNetwork.read(net).to_text())


# --BF16 and --INT8 against the JAX tool (the layer-by-layer pipeline: the
# stack has a sigmoid). bf16: each GEMM one rounding of an f32 sum that may
# land on the neighbouring bf16 value, then f32 sigmoid and softmax:
# posteriors within atol 2e-3; int8: int32 products exact, the scales f32,
# within atol 1e-5 (a quantum may flip on a rounding tie). Both stay near
# the f32 posteriors, within the JAX package's own bounds
# (tests/test_feacat_norm.py: 5e-2, and the argmax on over 90% of frames)
@pytest.mark.parametrize("flag", ["--BF16=TRUE", "--INT8=TRUE"])
def test_tfeacat_inference_dtypes_match_jax(corpus, tmp_path, flag):
    dirs = {name: tmp_path / name for name in ("jax", "torch", "f32")}
    for p in dirs.values():
        p.mkdir()
    assert jtfeacat.main(_tfeacat_argv(corpus, dirs["jax"], flag)) == 0
    assert ttfeacat.main(_tfeacat_argv(corpus, dirs["torch"], flag), device="cpu") == 0
    assert ttfeacat.main(_tfeacat_argv(corpus, dirs["f32"]), device="cpu") == 0
    names = sorted(p.name for p in dirs["jax"].iterdir())
    assert len(names) == SHAPE.n_cv and names == sorted(p.name for p in dirs["torch"].iterdir())
    atol = 2e-3 if flag.startswith("--BF16") else 1e-5
    for name in names:
        j, t, f = (htk.read_htk_file(str(dirs[k] / name))[0] for k in ("jax", "torch", "f32"))
        assert t.shape == j.shape == f.shape and np.isfinite(t).all()
        np.testing.assert_allclose(t, j, rtol=0, atol=atol)
        assert np.abs(t - f).max() < 5e-2 and not np.array_equal(t, f)
        assert (t.argmax(1) == f.argmax(1)).mean() > 0.9


def _tnorm_argv(d, target, transform):
    extra = ["-H", str(d / "transform")] if transform else []
    return ["tnorm", *extra, "-S", str(d / "train.scp"), f"--STARTFRMEXT={SHAPE.ext}",
            f"--ENDFRMEXT={SHAPE.ext}", f"--TARGETMMF={target}"]


@pytest.mark.parametrize("transform", [True, False])
def test_tnorm_matches_jax(corpus, tmp_path, transform):
    jout, tout = tmp_path / "jax.mmf", tmp_path / "torch.mmf"
    assert jtnorm.main(_tnorm_argv(corpus, jout, transform)) == 0
    assert ttnorm.main(_tnorm_argv(corpus, tout, transform), device="cpu") == 0
    jnet, tnet = JNetwork.read(str(jout)), JNetwork.read(str(tout))
    assert [s.tag for s in tnet.specs] == [s.tag for s in jnet.specs] == ["<bias>", "<window>"]
    dim = SHAPE.feat_dim * SHAPE.dct if transform else SHAPE.feat_dim
    for a, b in zip(tnet.params, jnet.params):
        for k in a:
            assert a[k].shape == (dim,) and np.isfinite(a[k]).all()
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("tool", ["tfeacat", "tnorm"])
def test_tools_need_cuda_unless_cpu_is_named(corpus, tmp_path, tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if tool == "tfeacat":
            ttfeacat.main(_tfeacat_argv(corpus, tmp_path))
        else:
            ttnorm.main(_tnorm_argv(corpus, tmp_path / "n.mmf", True))
