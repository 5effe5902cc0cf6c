"""The port's ``tools/generators.py`` against the JAX package's, on the CPU.

The subcommands that read MMF files through each package's ``models/``
(``netjoin``, with and without ``--bndim``, and ``rbm2mlplayer`` of
Bernoulli and Gaussian hidden units) write byte-identical text; the
jax-free subcommands are held in tests/test_torch_host_copies.py. Both
packages offer the same subcommands.
"""

import contextlib
import io

import pytest

from nnet_asr_tpu.tools import gen_mlp_init as jgen_mlp_init
from nnet_asr_tpu.tools import generators as jgenerators
from nnet_asr_torch.tools import generators as tgenerators


def _stdout_of(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


def _usage(main):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        main(["--help"])
    return buf.getvalue()


def test_same_subcommands():
    usage = _usage(tgenerators.main)
    assert usage == _usage(jgenerators.main)
    assert usage.count(",") >= 11 and "{rbm_init,recurrent_init," in usage


@pytest.fixture(scope="module")
def mmfs(tmp_path_factory):
    d = tmp_path_factory.mktemp("gen")
    files = {
        "rbm_bern": ["rbm_init", "--dim=7:5", "--negbias", "--seed=1"],
        "rbm_gauss_hid": ["rbm_init", "--dim=6:4", "--gauss", "--hidtype=gauss", "--seed=2"],
        "rbmsparse": ["rbm_init", "--dim=5:3", "--vistype=gauss", "--sparsitycost=1e-3",
                      "--seed=3"],
        "recurrent": ["recurrent_init", "--dim=4:6", "--gauss", "--seed=4"],
        "transform": ["splice", "--dimIn=2", "--startFrmExt=1", "--endFrmExt=1"],
    }
    for name, argv in files.items():
        (d / name).write_text(_stdout_of(jgenerators.main, argv))
    (d / "mlp").write_text(_stdout_of(jgen_mlp_init.main, ["--dim=6:5:3", "--gauss", "--seed=5"]))
    (d / "top").write_text(_stdout_of(jgen_mlp_init.main, ["--dim=5:4:3", "--seed=6"]))
    return d


@pytest.mark.parametrize("infiles,bndim", [
    (("transform", "mlp"), 0), (("recurrent", "mlp"), 0), (("mlp", "top"), 0),
    (("rbmsparse", "recurrent"), 0), (("mlp", "top"), 4), (("transform", "mlp", "top"), 5),
])
def test_netjoin_byte_equal_to_jax(mmfs, infiles, bndim):
    argv = ["netjoin", *(str(mmfs / f) for f in infiles)]
    if bndim:
        argv.insert(1, f"--bndim={bndim}")
    want = _stdout_of(jgenerators.main, argv)
    assert _stdout_of(tgenerators.main, argv) == want and want


def test_netjoin_bndim_not_found_raises_as_jax(mmfs):
    argv = ["netjoin", "--bndim=9", str(mmfs / "mlp")]
    for main in (jgenerators.main, tgenerators.main):
        with pytest.raises(SystemExit, match="No updatable layer with output dim 9"):
            main(argv)


@pytest.mark.parametrize("name", ["rbm_bern", "rbm_gauss_hid", "rbmsparse"])
def test_rbm2mlplayer_byte_equal_to_jax(mmfs, tmp_path, name):
    out = {}
    for pkg, main in (("jax", jgenerators.main), ("torch", tgenerators.main)):
        dst = tmp_path / f"{pkg}.mmf"
        assert main(["rbm2mlplayer", str(mmfs / name), str(dst)]) == 0
        out[pkg] = dst.read_text()
    assert out["torch"] == out["jax"]
    assert out["torch"].startswith("<biasedlinearity>")
    assert ("<sigmoid>" in out["torch"]) == (name != "rbm_gauss_hid")
    for main in (jgenerators.main, tgenerators.main):
        with pytest.raises(SystemExit, match="missing <rbm> tag"):
            main(["rbm2mlplayer", str(mmfs / "mlp"), str(tmp_path / "x.mmf")])
