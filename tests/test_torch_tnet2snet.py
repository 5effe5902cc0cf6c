"""The port's tnet2snet against the JAX package's, on the same MMFs.

``nnet_asr_torch/tools/tnet2snet.py`` converts over the port's ``models/``
(the JAX tool over the JAX models); on an MLP, a transform chain (with and
without ``--bndim``), and BlockSoftmax, shared and block layers, both must
write the same SNet text, to a file and to stdout.
"""

import contextlib
import io

import pytest

from nnet_asr_torch.tools import gen_mlp_init as t_gen_mlp_init
from nnet_asr_torch.tools import generators as t_generators
from nnet_asr_torch.tools import tnet2snet as t_tnet2snet
from nnet_asr_tpu.tools import tnet2snet as j_tnet2snet

TRANSFORM_MMF = """<expand> 6 2
v 3 -1 0 1
<transpose> 6 6
 3
<window> 6 6
v 6 1 2 3 4 5 6
<bias> 6 6
v 6 0.5 0.5 0.5 0.5 0.5 0.5
<log> 6 6
"""

BLOCKS_MMF = """<sharedlinearity> 4 4
2
m 2 2
1 2
3 4
v 2 0.25 -0.5
<blocklinearity> 4 4
m 2 2
0.5 -1
2 0.125
<sigmoid> 4 4
<blocksoftmax> 4 4
v 2 2 2
"""


def _stdout(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def mmfs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mmfs")
    (d / "mlp.mmf").write_text(_stdout(t_gen_mlp_init.main,
                                       ["--dim=6:9:7:5", "--gauss", "--negbias", "--seed=11"]))
    (d / "transform.mmf").write_text(TRANSFORM_MMF)
    (d / "hamm.mmf").write_text(_stdout(t_generators.main, [
        "hamm_dct", "--dimIn=2", "--startFrmExt=2", "--endFrmExt=2", "--dctBaseCnt=3"]))
    (d / "blocks.mmf").write_text(BLOCKS_MMF)
    (d / "shared.mmf").write_text(_stdout(t_generators.main, [
        "sharedlinearity_init", "--dim=8:6:4", "--inst=2:2", "--seed=8"]))
    return d


CASES = {
    "mlp": (["mlp.mmf"], []),
    "transform_then_mlp": (["transform.mmf", "mlp.mmf"], []),
    "transform_then_mlp_bndim": (["transform.mmf", "mlp.mmf"], ["--bndim=9"]),
    "hamm_dct": (["hamm.mmf"], []),
    "hamm_dct_bndim": (["hamm.mmf", "mlp.mmf"], ["--bndim=6"]),
    "blocks": (["blocks.mmf"], []),
    "shared": (["shared.mmf"], []),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_tnet2snet_matches_jax(mmfs, tmp_path, name):
    infiles, extra = CASES[name]
    paths = [str(mmfs / f) for f in infiles]
    out_t, out_j = tmp_path / "t.snet", tmp_path / "j.snet"
    assert t_tnet2snet.main(["tnet2snet", *extra, *paths, str(out_t)]) == 0
    assert j_tnet2snet.main(["tnet2snet", *extra, *paths, str(out_j)]) == 0
    text = out_t.read_text()
    assert text.startswith('~x "NNetsFwdComplete"\n')
    assert text == out_j.read_text()
    assert _stdout(t_tnet2snet.main, ["tnet2snet", *extra, *paths, "-"]) == \
        _stdout(j_tnet2snet.main, ["tnet2snet", *extra, *paths, "-"])
