"""The port's copies of the JAX package's host modules behave as the originals.

``nnet_asr_torch`` keeps its own copy of every jax-free host module it uses
(``io/``, ``utils/``, ``train/newbob.py``, ``tools/gen_mlp_init.py``,
``tools/generators.py``'s jax-free subcommands, ``train/rbm_scheduler.py``).
Each case feeds one copy and its
original the same inputs and holds the outputs equal: streams, parsed
values, decisions, and written files byte for byte.
"""

import contextlib
import io
import os

import numpy as np
import pytest

from nnet_asr_torch.io import htk as t_htk
from nnet_asr_torch.io import labels as t_labels
from nnet_asr_torch.io import mlf as t_mlf
from nnet_asr_torch.io import mmf as t_mmf
from nnet_asr_torch.io import native as t_native
from nnet_asr_torch.io import scp as t_scp
from nnet_asr_torch.tools import gen_mlp_init as t_gen_mlp_init
from nnet_asr_torch.tools import generators as t_generators
from nnet_asr_torch.train import newbob as t_newbob
from nnet_asr_torch.train import rbm_scheduler as t_rbm_scheduler
from nnet_asr_torch.utils import config as t_config
from nnet_asr_torch.utils import prefetch as t_prefetch
from nnet_asr_torch.utils import profiler as t_profiler
from nnet_asr_torch.utils import rand48 as t_rand48
from nnet_asr_tpu.io import htk as j_htk
from nnet_asr_tpu.io import labels as j_labels
from nnet_asr_tpu.io import mlf as j_mlf
from nnet_asr_tpu.io import mmf as j_mmf
from nnet_asr_tpu.io import native as j_native
from nnet_asr_tpu.io import scp as j_scp
from nnet_asr_tpu.tools import gen_mlp_init as j_gen_mlp_init
from nnet_asr_tpu.tools import generators as j_generators
from nnet_asr_tpu.train import newbob as j_newbob
from nnet_asr_tpu.train import rbm_scheduler as j_rbm_scheduler
from nnet_asr_tpu.utils import config as j_config
from nnet_asr_tpu.utils import prefetch as j_prefetch
from nnet_asr_tpu.utils import profiler as j_profiler
from nnet_asr_tpu.utils import rand48 as j_rand48


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(*args)
    return buf.getvalue(), ret


def _read(path, mode="rb"):
    with open(path, mode) as f:
        return f.read()


def _feats(seed=0, n=37, dim=5):
    return np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32)


# --------------------------------------------------------------------------
# one function per copy: (torch module, jax module, tmp dir) -> outputs
# --------------------------------------------------------------------------

def case_rand48(m, d):
    r = m.Rand48(12345)
    stream = [r.lrand48() for _ in range(50)] + [r.drand48() for _ in range(10)]
    return stream, m.Rand48(7).permutation(1000).tolist()


def case_htk(m, d):
    x = _feats(1)
    out = []
    for kind in (m.PARMKIND_USER, m.parse_parmkind("MFCC_D_A_C")):
        path = os.path.join(d, f"f{kind}.fea")
        m.write_htk_file(path, x, kind)
        data, hdr = m.read_htk_file(path)
        out.append((_read(path), data.tobytes(), hdr))
    return out, m.parmkind_to_str(m.parse_parmkind("FBANK_E_D_Z")), \
        m.make_htk_filename("a/b/utt1.fea", "lab", "lab")


def case_htk_reader(m, d):
    path = os.path.join(d, "u.fea")
    m.write_htk_file(path, _feats(2, n=20, dim=3), m.PARMKIND_USER)
    reader = m.FeatureReader(start_frm_ext=4, end_frm_ext=3)
    return reader.read(path).tobytes(), reader.read(f"{path}[2,9]").tobytes()


def case_native(m, d):
    path = os.path.join(d, "n.fea")
    j_htk.write_htk_file(path, _feats(3, n=15, dim=4), j_htk.PARMKIND_USER)
    if not m.available():
        return False
    return True, m.read_header(path), m.read_frames(path, True, 2, 10, 3, 2).tobytes()


def case_mmf(m, d):
    ts = m.TokenStream("<biasedlinearity> 3 2\nm 3 2\n 1 2\n3 4\n5 6\nv 3\n0.5 -1 2e-3\n")
    toks = [ts.next(), ts.next(), ts.next()]
    mat = m.read_matrix(ts)
    vec = m.read_vector(ts)
    buf = io.StringIO()
    m.write_vector(buf, np.array([0.1, -2.5, 3e-7, 1 / 3], np.float32))
    m.write_matrix(buf, _feats(4, n=3, dim=4))
    return toks, mat.tobytes(), vec.tobytes(), ts.eof(), buf.getvalue()


def case_scp(m, d):
    lines = ["a/b/c.fea", "utt1=/data/x.fea[10,20]", r"w\x\y.fea{0.5}",
             " u2 = /p/q.fea[0,5] {2}"]
    path = os.path.join(d, "list.scp")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n\n")
    return [m.parse_scp_entry(s) for s in lines], m.read_scp(path)


def _write_mlf(m, path):
    w = m.MlfWriter(path)
    w.write_record("*/u1.lab", ["0 300000 s1", "300000 700000 s2"])
    w.write_record("*/u2.lab", ["0 200000 s2", "200000 500000 s0"])
    w.write_record("dir/u3.lab", ["0 100000 s0"])
    w.close()


def case_mlf(m, d):
    path = os.path.join(d, "labs.mlf")
    _write_mlf(m, path)
    r = m.MlfReader(path)
    got = (_read(path), sorted(r.names()), r.read_intervals("x/y/u1.lab"),
           r.read_block("dir/u3.lab"), "x/u2.lab" in r, "q/u9.lab" in r)
    r.close()
    return got


def case_labels(m, d):
    path, mapf = os.path.join(d, "labs.mlf"), os.path.join(d, "map")
    _write_mlf(j_mlf, path)
    with open(mapf, "w") as f:
        f.write("s0 s1 s2\n")
    rep = m.LabelRepository(path, mapf, label_dir="*/", label_ext="lab")
    return (rep.get_frame_labels(7, 100000, "feats/u1.fea").tolist(),
            rep.get_onehot(5, 100000, "feats/u2.fea").tobytes(), rep.n_outputs)


OPTIONS = " -c n   CROSSVALIDATE=TRUE -n r   LEARNINGRATE -H l   SOURCEMMF -T r   TRACE"


def case_config(m, d):
    cfg = os.path.join(d, "cfg")
    with open(cfg, "w") as f:
        f.write("# comment\nTNET:BUNCHSIZE = 256\nTNET:TARGETKIND = MFCC_D_A\n")
    ui = m.UserInterface()
    argv = ["tnet", "-C", cfg, "-c", "-n", "0.008", "-H", "a.mmf", "-H", "b.mmf",
            "-T", "021", "--SEED=0x1f", "--RANDOMIZE=F", "--STARTFRMEXT=5", "x.scp"]
    first = ui.parse_options(argv, OPTIONS, "tnet")
    got = (first, ui.get_bool("CROSSVALIDATE"), ui.get_flt("LEARNINGRATE"),
           ui.get_str("SOURCEMMF"), ui.get_int("TRACE"), ui.get_int("SEED"),
           ui.get_bool("RANDOMIZE", True), ui.get_int("BUNCHSIZE"),
           ui.get_enum("MISSING", "a", ["a", "b"]), ui.get_feature_params())
    with pytest.raises(ValueError, match="Unexpected command-line"):
        _check_unused(m)
    return got, _stdout(ui.print_config)[0]


def _check_unused(m):
    ui = m.UserInterface()
    ui.parse_options(["tnet", "--TYPO=1"], OPTIONS, "tnet")
    ui.check_command_line_param_use()


def case_prefetch(m, d):
    return list(m.prefetch_map(lambda v: v * v, range(57), workers=3, depth=5))


def case_profiler(m, d):
    p = m.Profiler()
    with p.phase("off"):
        pass
    p.enabled = True
    for name in ("read", "step", "read"):
        with p.phase(name):
            pass
    p.accu("step", 2.0)
    report = p.report()
    # times differ; names, order, counts and layout do not
    return sorted(p._counts.items()), [line.split()[0] for line in report.splitlines()], \
        [line.split()[-1] for line in report.splitlines()[1:-1]], p.value("off")


# accuracies the scripted epochs reach: accepts, a rejection, halving, stop
CV_SCRIPT = {"init.mmf": 10.0}
TRAIN_SCRIPT = [(30.0, 31.0), (35.0, 29.0), (38.0, 33.0), (40.0, 33.2), (41.0, 33.25),
                (42.0, 33.27)]


def case_newbob(m, d):
    init = os.path.join(d, "init.mmf")
    with open(init, "w") as f:
        f.write("init\n")
    cv, epochs, logs = dict(CV_SCRIPT), iter(TRAIN_SCRIPT), []

    def train_epoch(src, lrate, dst):
        tr, cv_acc = next(epochs)
        with open(dst, "w") as f:
            f.write(f"{os.path.basename(src)} {lrate!r}\n")
        cv[os.path.basename(dst)] = cv_acc
        return tr

    def crossvalidate(mmf):
        return cv[os.path.basename(mmf)]

    cfg = m.NewbobConfig(learning_rate=0.5, max_iter=6, min_iter=2, keep_lrate_iter=1)
    best, st = run = m.run_newbob(cfg, init, os.path.join(d, "w"), train_epoch,
                                  crossvalidate, log=logs.append)
    rel = lambda p: os.path.relpath(p, d)   # noqa: E731
    files = sorted(os.listdir(os.path.join(d, "w")))
    hist = [{k: (rel(v) if k == "model" else v) for k, v in h.items()} for h in st.history]
    assert run[0] == best
    return rel(best), st.lrate, st.accu_best, st.do_halving, st.iter, hist, logs, files, \
        [_read(os.path.join(d, "w", f), "r") for f in files]


def case_hamm_dct(m, d):
    return _stdout(m.main, ["hamm_dct", "--dimIn=23", "--startFrmExt=25",
                            "--endFrmExt=25", "--dctBaseCnt=26"])


# the jax-free subcommands of generators.py, each with its options (netjoin
# and rbm2mlplayer read through each package's models/:
# tests/test_torch_generators.py)
GENERATORS = {
    "rbm_init": [["rbm_init", "--dim=7:5", "--seed=3"],
                 ["rbm_init", "--dim=6:4", "--gauss", "--negbias", "--vistype=gauss", "--seed=4"],
                 ["rbm_init", "--dim=5:3", "--hidtype=gauss", "--sparsitycost=1e-4", "--seed=5"]],
    "recurrent_init": [["recurrent_init", "--dim=4:6:3", "--gauss", "--negbias", "--seed=6"],
                       ["recurrent_init", "--dim=3:2", "--seed=7"]],
    "sharedlinearity_init": [["sharedlinearity_init", "--dim=8:6:4", "--inst=2:2", "--seed=8"],
                             ["sharedlinearity_init", "--dim=8:6", "--inst=2", "--gauss",
                              "--linBNdim=6", "--seed=9"]],
    "discretelinearity_init": [["discretelinearity_init", "--dim=8:6:4", "--blocks=2",
                                "--gauss", "--negbias", "--seed=10"]],
    "splice": [["splice", "--dimIn=5", "--startFrmExt=3", "--endFrmExt=2"]],
    "empty": [["empty", "--dimIn=7"]],
    "lcrc_hamm_dct": [["lcrc_hamm_dct", "--dimIn=4", "--startFrmExt=5", "--endFrmExt=5",
                       "--dctBaseCnt=3"]],
    "rasta": [["rasta", "--dimIn=3"]],
}


def _case_generator(name):
    def case(m, d):
        return [_stdout(m.main, argv) for argv in GENERATORS[name]]
    return case


def case_rbm_scheduler(m, d):
    out = []
    for gaussian in (False, True):
        rbm = os.path.join(d, f"rbm{int(gaussian)}.mmf")
        with open(rbm, "w") as f:
            f.write("rbm\n")
        calls, logs = [], []

        def train_iter(mmf, lrate, momentum, weightcost):
            calls.append((os.path.basename(mmf), lrate, momentum, weightcost))
            with open(mmf, "a") as f:
                f.write(f"{lrate!r} {momentum!r}\n")

        cfg = m.RbmSchedulerConfig(iters=7, iters_high=9, savepoints=3)
        m.run_rbm_schedule(cfg, rbm, train_iter, gaussian, log=logs.append)
        saved = sorted(f for f in os.listdir(d) if f.startswith(f"rbm{int(gaussian)}.mmf_"))
        out.append((calls, [line.replace(d, "") for line in logs], saved,
                    [_read(os.path.join(d, f), "r") for f in saved]))
    return out


def case_gen_mlp_init(m, d):
    return _stdout(m.main, ["--dim=40:16:9", "--gauss", "--negbias", "--seed=999"]), \
        _stdout(m.main, ["--dim=12:7:5:3", "--seed=5"])


CASES = {
    "rand48": (case_rand48, t_rand48, j_rand48),
    "htk": (case_htk, t_htk, j_htk),
    "htk_reader": (case_htk_reader, t_htk, j_htk),
    "native": (case_native, t_native, j_native),
    "mmf": (case_mmf, t_mmf, j_mmf),
    "scp": (case_scp, t_scp, j_scp),
    "mlf": (case_mlf, t_mlf, j_mlf),
    "labels": (case_labels, t_labels, j_labels),
    "config": (case_config, t_config, j_config),
    "prefetch": (case_prefetch, t_prefetch, j_prefetch),
    "profiler": (case_profiler, t_profiler, j_profiler),
    "newbob": (case_newbob, t_newbob, j_newbob),
    "hamm_dct": (case_hamm_dct, t_generators, j_generators),
    "gen_mlp_init": (case_gen_mlp_init, t_gen_mlp_init, j_gen_mlp_init),
    "rbm_scheduler": (case_rbm_scheduler, t_rbm_scheduler, j_rbm_scheduler),
    **{f"generators_{name}": (_case_generator(name), t_generators, j_generators)
       for name in GENERATORS},
}


def _plain(v):
    """Dataclasses of the two packages compare by their fields."""
    if hasattr(v, "__dataclass_fields__"):
        return (type(v).__name__, {k: _plain(getattr(v, k)) for k in v.__dataclass_fields__})
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return v


@pytest.mark.parametrize("name", sorted(CASES))
def test_copy_matches_original(name, tmp_path):
    fn, port, orig = CASES[name]
    assert port.__name__.startswith("nnet_asr_torch.")
    assert orig.__name__.startswith("nnet_asr_tpu.")
    dt, dj = tmp_path / "torch", tmp_path / "jax"
    dt.mkdir()
    dj.mkdir()
    got, want = fn(port, str(dt)), fn(orig, str(dj))
    assert _plain(got) == _plain(want)


def test_native_library_is_the_ports_own():
    """The port builds its own copy of htkio.cc into its own cache."""
    assert os.path.realpath(t_native._source_path()).startswith(
        os.path.realpath(os.path.dirname(os.path.dirname(t_native.__file__))))
    assert "nnet_asr_tpu" not in t_native.CACHE_DIR
    with open(t_native._source_path()) as f:
        port_src = f.read()
    with open(j_native._source_path()) as f:
        orig_src = f.read()
    # the copy adds a note at the top and changes no line of code
    assert port_src.endswith(orig_src.split("\n", 3)[3])
