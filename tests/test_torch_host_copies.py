"""The port's copies of the JAX package's host modules behave as the originals.

``nnet_asr_torch`` keeps its own copy of every jax-free host module it uses
(``io/``, ``utils/``, ``train/newbob.py``, ``tools/gen_mlp_init.py``,
``tools/generators.py``'s jax-free subcommands, ``train/rbm_scheduler.py``,
and the MPE host code: ``io/{htk_hmm,slf,dictionary}.py``,
``train/{lattice_expand,mpe_native,mpe}.py``, ``tools/gen_gmmbypass.py``;
the file-level tools: ``io/wav.py``, ``ops/mfcc.py``, ``tools/{thcopy,
tjoiner,tsegmenter,sresults,gen_phone_loop}.py``). Each case feeds one copy and its
original the same inputs and holds the outputs equal: streams, parsed
values, decisions, and written files byte for byte.
"""

import contextlib
import gzip
import importlib
import io
import os
import re
import struct
import time

import numpy as np
import pytest

from nnet_asr_torch.io import dictionary as t_dictionary
from nnet_asr_torch.io import htk as t_htk
from nnet_asr_torch.io import htk_hmm as t_htk_hmm
from nnet_asr_torch.io import slf as t_slf
from nnet_asr_torch.io import labels as t_labels
from nnet_asr_torch.io import mlf as t_mlf
from nnet_asr_torch.io import mmf as t_mmf
from nnet_asr_torch.io import native as t_native
from nnet_asr_torch.io import scp as t_scp
from nnet_asr_torch.io import wav as t_wav
from nnet_asr_torch.ops import mfcc as t_mfcc
from nnet_asr_torch.tools import gen_gmmbypass as t_gen_gmmbypass
from nnet_asr_torch.tools import gen_mlp_init as t_gen_mlp_init
from nnet_asr_torch.tools import gen_phone_loop as t_gen_phone_loop
from nnet_asr_torch.tools import generators as t_generators
from nnet_asr_torch.tools import sresults as t_sresults
from nnet_asr_torch.tools import thcopy as t_thcopy
from nnet_asr_torch.tools import tjoiner as t_tjoiner
from nnet_asr_torch.tools import tsegmenter as t_tsegmenter
from nnet_asr_torch.train import lattice_expand as t_lattice_expand
from nnet_asr_torch.train import mpe as t_mpe
from nnet_asr_torch.train import mpe_native as t_mpe_native
from nnet_asr_torch.train import newbob as t_newbob
from nnet_asr_torch.train import rbm_scheduler as t_rbm_scheduler
from nnet_asr_torch.utils import config as t_config
from nnet_asr_torch.utils import prefetch as t_prefetch
from nnet_asr_torch.utils import profiler as t_profiler
from nnet_asr_torch.utils import rand48 as t_rand48
from nnet_asr_tpu.io import dictionary as j_dictionary
from nnet_asr_tpu.io import htk as j_htk
from nnet_asr_tpu.io import htk_hmm as j_htk_hmm
from nnet_asr_tpu.io import slf as j_slf
from nnet_asr_tpu.io import labels as j_labels
from nnet_asr_tpu.io import mlf as j_mlf
from nnet_asr_tpu.io import mmf as j_mmf
from nnet_asr_tpu.io import native as j_native
from nnet_asr_tpu.io import scp as j_scp
from nnet_asr_tpu.io import wav as j_wav
from nnet_asr_tpu.ops import mfcc as j_mfcc
from nnet_asr_tpu.tools import gen_gmmbypass as j_gen_gmmbypass
from nnet_asr_tpu.tools import gen_mlp_init as j_gen_mlp_init
from nnet_asr_tpu.tools import gen_phone_loop as j_gen_phone_loop
from nnet_asr_tpu.tools import generators as j_generators
from nnet_asr_tpu.tools import sresults as j_sresults
from nnet_asr_tpu.tools import thcopy as j_thcopy
from nnet_asr_tpu.tools import tjoiner as j_tjoiner
from nnet_asr_tpu.tools import tsegmenter as j_tsegmenter
from nnet_asr_tpu.train import lattice_expand as j_lattice_expand
from nnet_asr_tpu.train import mpe as j_mpe
from nnet_asr_tpu.train import mpe_native as j_mpe_native
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
        pytest.skip(f"{m.__name__}: g++ did not build the library")
    return m.read_header(path), m.read_frames(path, True, 2, 10, 3, 2).tobytes()


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
            if name == "step":
                time.sleep(0.05)
    lines = p.report().splitlines()
    # times differ; phase names, their order, call counts and layout do not
    return [line.split()[0] for line in lines], \
        [line.split()[-1] for line in lines[1:-1]], [len(line.split()) for line in lines]


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


# --------------------------------------------------------------------------
# the MPE host code: HMM sets, lattices, dictionaries, expansion, engines
# --------------------------------------------------------------------------

def _sibling(m, name):
    """Module ``name`` (e.g. "io.slf") of the package ``m`` belongs to."""
    return importlib.import_module(f"{m.__name__.split('.')[0]}.{name}")


HMM_MMF = """~o <STREAMINFO> 1 4 <VECSIZE> 4 <USER>
~h "a"
<BEGINHMM>
<NUMSTATES> 4
<STATE> 2
~s "a_s2"
<STATE> 3
~s "a_s3"
<TRANSP> 4
 0.0 1.0 0.0 0.0
 0.0 0.3 0.7 0.0
 0.0 0.0 0.6 0.4
 0.0 0.0 0.0 0.0
<ENDHMM>
~h "b"
<BEGINHMM>
<NUMSTATES> 3
<STATE> 2
<MEAN> 4
 0 0 0 0
<TRANSP> 3
 0.0 1.0 0.0
 0.0 0.5 0.5
 0.0 0.0 0.0
<ENDHMM>
~h "c"
<BEGINHMM>
<NUMSTATES> 3
<STATE> 2
~s "c_s2"
<TRANSP> 3
 0.0 1.0 0.0
 0.0 0.8 0.2
 0.0 0.0 0.0
<ENDHMM>
"""
MPE_LABELS = {"a_s2": 0, "a_s3": 1, "b_s2": 2, "c_s2": 3}


def _hmms(m, d):
    path = os.path.join(d, "hmms.mmf")
    with open(path, "w") as f:
        f.write(HMM_MMF)
    return _sibling(m, "io.htk_hmm").parse_mmf(path)


def case_htk_hmm(m, d):
    hmms = _hmms(m, d)
    return [(n, h.n_states, h.n_emitting, h.transp.tobytes(), h.state_names,
             h.senone_ids(MPE_LABELS)) for n, h in hmms.items()]


# a phone lattice: a diamond with a !NULL arc and same-time nodes
SLF = """VERSION=1.0
lmscale=9.0
N=6 L=7
I=0 t=0.00
I=1 t=0.07
I=2 t=0.07
I=3 t=0.10
I=4 t=0.10
I=5 t=0.16
J=0 S=0 E=1 W=a a=-1.5 l=-0.3
J=1 S=0 E=2 W=b l=-0.1
J=2 S=1 E=3 W=c l=0.0
J=3 S=2 E=3 W=b l=-0.2
J=4 S=3 E=4 W=!NULL
J=5 S=4 E=5 W=a l=-0.5
J=6 S=4 E=5 W=c l=-1.0
"""
# the STK node-list dialect (SVite output)
STK_NET = "0 t=0.00\n1 t=0.05 W=a\n2 t=0.10 M=b\n0 1 a=-3.5 l=-1\n1 2 a=-2\n"


def case_slf(m, d):
    lat = m.read_slf(io.StringIO(SLF))
    out = io.StringIO()
    m.write_slf(lat, out)
    again = io.StringIO()
    m.write_slf(m.read_slf(io.StringIO(out.getvalue())), again)
    stk = m.read_slf(io.StringIO(STK_NET))
    # the two transports of LatticeArchive: a directory (plain and .gz) and
    # an MLF of lattice records
    lats = os.path.join(d, "lats")
    os.makedirs(lats)
    with open(os.path.join(lats, "u1.lat"), "w") as f:
        f.write(out.getvalue())
    with gzip.open(os.path.join(lats, "u2.lat.gz"), "wt") as f:
        f.write(STK_NET)
    mlf = os.path.join(d, "lats.mlf")
    with open(mlf, "w") as f:
        f.write('#!MLF!#\n"*/u1.lat"\n' + out.getvalue() + '.\n"*/u2.lat"\n'
                + STK_NET + ".\n")
    got = [m.LatticeArchive(src).get(f"feats/{u}.fea") for src in (lats, mlf)
           for u in ("u1", "u2")]
    with pytest.raises(FileNotFoundError):
        m.LatticeArchive(lats).get("u9.fea")
    return (out.getvalue(), again.getvalue() == out.getvalue(), lat, lat.lmscale,
            [lat.arc_word(a) for a in lat.arcs], lat.frame(5), stk, got)


DICT = """A a
B [bee] 0.25 b
AB a b
AB 0.5 a a b
'C D' [] c
SIL
"""


def _dictionary(m, d):
    path = os.path.join(d, "words.dic")
    with open(path, "w") as f:
        f.write(DICT)
    return _sibling(m, "io.dictionary").read_dictionary(path)


def case_dictionary(m, d):
    return _dictionary(m, d)


# a word lattice over 16 frames: AB or A then B, with competitors
WORD_SLF = """N=4 L=5
I=0 t=0.00
I=1 t=0.07
I=2 t=0.16
I=3 t=0.16
J=0 S=0 E=2 W=AB l=-0.5
J=1 S=0 E=1 W=A l=-0.2
J=2 S=1 E=2 W=B l=-0.1
J=3 S=0 E=2 W=c l=-2.0
J=4 S=2 E=3 W=SIL
"""


def _log_post(T=16, C=4, seed=21):
    return np.log(np.random.default_rng(seed).dirichlet(np.ones(C), size=T))


def case_lattice_expand(m, d):
    hmms, words = _hmms(m, d), _dictionary(m, d)
    lat = _sibling(m, "io.slf").read_slf(io.StringIO(WORD_SLF))
    comp = m.compose_hmms([hmms["a"], hmms["b"]], [[0, 1], [2]])
    out = [comp.entry.tobytes(), comp.trans.tobytes(), comp.exit.tobytes(), comp.tee,
           comp.phone_of_state.tobytes(), comp.senones.tobytes(),
           [m.min_duration(h) for h in hmms.values()]]
    score, path = m.viterbi_segment(comp, _log_post(7, 3), transp_scale=1.5)
    out.append((score, path.tobytes()))
    for kw in ({}, {"multiple_pronun": False, "pron_scale": 2.0, "word_penalty": -0.5},
               {"segmentation": "exact"}, {"segmentation": "exact", "exact_window": 1}):
        exp = m.LatticeExpander(hmms, MPE_LABELS, words, outprb_scale=0.5, **kw)
        out.append((exp.needs_expansion(lat), exp.expand(lat, _log_post())))
    return out


MPE_CONFIGS = [({}, {}), ({"outprb_scale": 0.3, "lm_scale": 2.0}, {}), ({"ml_gamma": True}, {}),
               ({"occup_scale": 0.7, "ml_gamma": True}, {}),
               ({"transp_scale": 2.0, "model_penalty": -1.5}, {}),
               ({"start_time_shift": 0.01, "end_time_shift": 0.01}, {}),
               ({}, {"utt_weight": 0.6, "frame_weights": np.linspace(0.5, 1.5, 16)}),
               ({}, {"pruning": 1e6}), ({"ml_gamma": True}, {"pruning": 3.0})]
REF_SEGS = [(0, 7, "a"), (7, 10, "b"), (10, 16, "c")]


def _case_mpe(engine):
    """Every configuration's (gammas, c_avg, logZ) of one engine, bits
    compared; then a word lattice through the expander."""
    def case(m, d):
        hmms = _hmms(m, d)
        slf = _sibling(m, "io.slf")
        if engine == "native" and not _sibling(m, "train.mpe_native").available():
            pytest.skip(f"{m.__name__}: g++ did not build the MPE library")
        out = []
        for cfg, kw in MPE_CONFIGS:
            comp = m.MpeComputer(hmms, MPE_LABELS, m.MpeConfig(**cfg), engine=engine)
            assert (comp._native is not None) == (engine == "native")
            g, c, z = comp.compute(slf.read_slf(io.StringIO(SLF)), _log_post(), REF_SEGS, **kw)
            out.append((g.tobytes(), c, z))
        comp = m.MpeComputer(hmms, MPE_LABELS, m.MpeConfig(exact_segmentation=True),
                             engine=engine, dictionary=_dictionary(m, d))
        g, c, z = comp.compute(slf.read_slf(io.StringIO(WORD_SLF)), _log_post(), REF_SEGS)
        out.append((g.tobytes(), c, z))
        out.append([m.labels_to_phone_segments(np.array([0, 0, 1, 2, 2, 3]),
                                               ["a_s2", "a_s3", "b_s2", "c_s2"]),
                    m.povey_phone_accuracy("a", 5, 15, REF_SEGS)])
        return out
    return case


def case_mpe_native(m, d):
    if not m.available():
        pytest.skip(f"{m.__name__}: g++ did not build the MPE library")
    hmms = _hmms(m, d)
    mpe = _sibling(m, "train.mpe")
    comp = mpe.MpeComputer(hmms, MPE_LABELS, mpe.MpeConfig(), engine="numpy")
    tables = m.NativeTables(list(hmms), comp._senone_cache, comp._log_tp)
    lat = _sibling(m, "io.slf").read_slf(io.StringIO(SLF))
    flat = m.flatten_lattice(lat, tables)
    assert m.flatten_lattice(lat, tables) is flat           # cached on the lattice
    g, c, z = m.compute_native(lat, _log_post(), REF_SEGS, tables, mpe.MpeConfig(),
                               kappa=0.5, beam=4.0)
    return ([a.tobytes() for a in flat], tables.h_S.tobytes(), tables.h_sen.tobytes(),
            tables.h_tp.tobytes(), tables.seg_code("zz"), tables.seg_code("b"),
            g.tobytes(), c, z)


def case_gen_gmmbypass(m, d):
    mapf = os.path.join(d, "map")
    with open(mapf, "w") as f:
        f.write("p0_s2 p0_s3 p0_s4 p1_s2 p1_s3 p1_s4 sil\n")
    out = []
    for extra in (["--state-sep=_s"], ["--variance=2.5"]):
        hmm = os.path.join(d, "hmms.mmf")
        text = _stdout(m.main, [mapf, hmm, *extra])
        out.append((text[0].replace(d, ""), text[1], _read(hmm)))
    return out


# --------------------------------------------------------------------------
# the file-level tools: audio, the front end, thcopy, tjoiner, tsegmenter,
# sresults, gen_phone_loop
# --------------------------------------------------------------------------

HCOPY_ORACLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "hcopy_oracle")


def _samples(seed=5, n=8000):
    """Half a second at 16 kHz: two tones and noise, as int16."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = (6000 * np.sin(2 * np.pi * 440 * t) + 2500 * np.sin(2 * np.pi * 2300 * t)
         + 800 * rng.standard_normal(n))
    return x.astype(np.int16)


def _clean(text, d):
    """Stdout without the run's directory and wall times."""
    return re.sub(r"\d+\.\d+s|FPS:[\d.]+", "T", text.replace(d, ""))


def case_wav(m, d):
    s = _samples()
    out = []
    p = os.path.join(d, "a.wav")
    m.write_wav(p, s, 16000)
    got, rate = m.read_wav(p)
    out.append((_read(p), got.tobytes(), rate, m.sniff_audio(p)))
    for order, dt in (("vax", "<i2"), ("be", ">i2")):
        p = os.path.join(d, f"{order}.raw")
        with open(p, "wb") as f:
            f.write(s.astype(dt).tobytes())
        out.append((m.read_raw(p, order).tobytes(), m.sniff_audio(p)))
    for fmt in ("01", "10"):
        p = os.path.join(d, f"s{fmt}.sph")
        m.write_sphere(p, s, 16000, byte_format=fmt)
        got, rate = m.read_sphere(p)
        out.append((_read(p), got.tobytes(), rate, m.sniff_audio(p),
                    m.read_audio_auto(p)[0].tobytes()))
    for tag, endian in (("be", ">"), ("le", "<")):
        p = os.path.join(d, f"w_{tag}.htk")
        with open(p, "wb") as f:
            f.write(struct.pack(f"{endian}iihH", s.size, 625, 2, 0)
                    + s.astype(f"{endian}i2").tobytes())
        got, period = m.read_htk_waveform(p, endian == ">")
        auto, rate = m.read_audio_auto(p)
        out.append((got.tobytes(), period, m.sniff_audio(p), auto.tobytes(), rate))
    return out


FRONTENDS = [
    dict(target_kind="FBANK", numchans=23, use_power=True, preemcoef=0.0, lofreq=0,
         hifreq=8000),
    dict(target_kind="MFCC_0_D_A", numchans=26, numceps=12, ceplifter=22, preemcoef=0.97,
         lofreq=0, hifreq=8000, enormalise=False),
    dict(target_kind="MFCC_E_D_Z", numchans=20, numceps=13, zmean_source=True),
    dict(target_kind="MELSPEC_T", numchans=16, use_hamming=False, raw_energy=False),
    dict(target_kind="MFCC_0_E", numchans=20, numceps=12, enormalise=True, escale=0.2),
]


def case_mfcc(m, d):
    wav = _sibling(m, "io.wav")
    out = []
    for kw in FRONTENDS:
        fe = m.Frontend(m.FrontendConfig(**kw))
        feats = fe.extract(_samples())
        out.append((feats.tobytes(), feats.shape, fe.kind, fe.sample_period))
    # the HCopy oracle's recorded audio through its two configurations
    samples, rate = wav.read_wav(os.path.join(HCOPY_ORACLE, "oracle.wav"))
    for kw in FRONTENDS[:2]:
        cfg = m.FrontendConfig(**kw, use_hamming=True, source_rate=625.0,
                               target_rate=100000.0, window_size=250000.0)
        out.append((m.Frontend(cfg).extract(samples).tobytes(), rate))
    out.append(m.htk_regression_deltas(_feats(6, n=15, dim=3), 2).tobytes())
    with pytest.raises(ValueError, match="qualifier"):
        m.Frontend(m.FrontendConfig(target_kind="MFCC_C"))
    return out


THCOPY_CFG = ("SOURCEKIND = WAVEFORM\nSOURCERATE = 625\nTARGETKIND = FBANK\nLOFREQ = 0\n"
              "HIFREQ = 8000\nNUMCHANS = 23\nUSEPOWER = T\nPREEMCOEF = 0\n"
              "TARGETRATE = 100000\nWINDOWSIZE = 250000\n")


def case_thcopy(m, d):
    wav = _sibling(m, "io.wav")
    s = _samples(7)
    srcs = {"NOHEAD": os.path.join(d, "u.raw"), "WAV": os.path.join(d, "u.wav"),
            "NIST": os.path.join(d, "u.sph"), "HTK": os.path.join(d, "u.htk")}
    with open(srcs["NOHEAD"], "wb") as f:
        f.write(s.astype("<i2").tobytes())
    wav.write_wav(srcs["WAV"], s, 16000)
    wav.write_sphere(srcs["NIST"], s, 16000)
    with open(srcs["HTK"], "wb") as f:
        f.write(struct.pack(">iihH", s.size, 625, 2, 0) + s.astype(">i2").tobytes())
    out = []
    for fmt, extra in (("NOHEAD", "BYTEORDER = VAX\n"), ("NOHEAD", ""), ("WAV", ""),
                       ("NIST", ""), ("HTK", "TARGETKIND = MFCC_0_D_A\n")):
        cfg = os.path.join(d, f"{fmt}.cfg")
        with open(cfg, "w") as f:
            f.write(THCOPY_CFG + f"SOURCEFORMAT = {fmt}\n" + extra)
        dst = os.path.join(d, f"{fmt}{len(out)}.fea")
        text, rc = _stdout(m.main, ["thcopy", "-C", cfg, "-T", "1", srcs[fmt], dst])
        out.append((_clean(text, d), rc, _read(dst)))
    # a two-column script of pairs
    wav.write_wav(os.path.join(d, "v.wav"), _samples(8), 16000)
    scp = os.path.join(d, "pairs.scp")
    with open(scp, "w") as f:
        f.write(f"# src dst\n{srcs['WAV']} {d}/p1.fea\n{d}/v.wav {d}/p2.fea\n")
    cfg = os.path.join(d, "WAV.cfg")
    text, rc = _stdout(m.main, ["thcopy", "-C", cfg, "-S", scp])
    out.append((_clean(text, d), rc, _read(f"{d}/p1.fea"), _read(f"{d}/p2.fea")))
    return out


def _feature_files(d, lengths, dim, seed):
    rng = np.random.default_rng(seed)
    paths = []
    for i, n in enumerate(lengths):
        p = os.path.join(d, f"u{i}.fea")
        j_htk.write_htk_file(p, rng.standard_normal((n, dim)).astype(np.float32),
                             j_htk.PARMKIND_USER)
        paths.append(p)
    scp = os.path.join(d, "in.scp")
    with open(scp, "w") as f:
        f.write("\n".join(paths) + "\n")
    return scp


def _tree(d, sub):
    """(relative path, bytes) of every file under ``d/sub``."""
    root = os.path.join(d, sub)
    return sorted((os.path.relpath(os.path.join(r, n), d), _read(os.path.join(r, n)))
                  for r, _, names in os.walk(root) for n in names)


def case_tjoiner(m, d):
    out = []
    scp = _feature_files(d, [12, 13, 14, 10, 11], 4, seed=3)
    # frame extension with stored margins and NaN separators; a TARGETSIZE
    # that rolls archives; the TARGETSCRIPT alias and the FBANK target kind
    for k, extra in enumerate((["--STARTFRMEXT=2", "--ENDFRMEXT=2"],
                               ["--TARGETSIZE=30", "--STARTFRMEXT=1", "--ENDFRMEXT=3"],
                               ["--TARGETSIZE=25", "-y", "fj"])):
        outscp = os.path.join(d, f"out{k}.scp")
        name = "--OUTPUTSCRIPT=" if k < 2 else "--TARGETSCRIPT="
        text, rc = _stdout(m.main, ["tjoiner", "-S", scp, "-l", os.path.join(d, f"j{k}"),
                                    name + outscp, *extra])
        out.append((text, rc, _read(outscp, "r").replace(d, ""), _tree(d, f"j{k}")))
    return out


def case_tsegmenter(m, d):
    scp_in = _feature_files(d, [30, 25], 3, seed=1)
    with open(scp_in) as f:
        paths = f.read().split()
    scp = os.path.join(d, "seg.scp")
    with open(scp, "w") as f:
        f.write(f"{paths[0]}[5,14]\nlogical={paths[1]}[0,9]\n{paths[1]}\n")
    out = []
    for k, extra in enumerate(([], ["--NOSUBDIRS=TRUE", "--EXTRACTSEGMENTS=FALSE"])):
        outscp = os.path.join(d, f"out{k}.scp")
        text, rc = _stdout(m.main, ["tsegmenter", "-S", scp,
                                    "--TARGETPARAMDIR=" + os.path.join(d, f"l{k}"),
                                    "--TARGETSCRIPT=" + outscp, *extra])
        out.append((text.replace(d, ""), rc, _read(outscp, "r").replace(d, ""),
                    _tree(d, f"l{k}")))
    return out


def case_sresults(m, d):
    ref = j_mlf.MlfWriter(os.path.join(d, "ref.mlf"))
    ref.write_record("*/u1.lab", ["a", "b", "c", "d"])
    ref.write_record("*/u2.lab", ["0 10 a", "10 20 a", "20 30 b"])
    ref.write_record("*/u3.lab", ["sil", "x", "sil"])
    ref.close()
    hyp = j_mlf.MlfWriter(os.path.join(d, "hyp.mlf"))
    hyp.write_record("*/u1.rec", ["0 1 a -1.0", "1 2 x -1.0", "2 3 c -1.0"])
    hyp.write_record("*/u2.rec", ["0 1 a -1.0", "1 2 a -1.0", "2 3 b -1.0", "3 4 b -2.0"])
    hyp.write_record("*/u3.rec", ["sil", "x", "sil"])
    hyp.write_record("*/u9.rec", ["a"])
    hyp.close()
    return (_stdout(m.main, ["-I", os.path.join(d, "ref.mlf"), os.path.join(d, "hyp.mlf")]),
            m.align_counts(list("abcab"), list("acbba")), m.align_counts([], list("ab")))


def case_gen_phone_loop(m, d):
    phones = os.path.join(d, "phones")
    with open(phones, "w") as f:
        f.write("aa ae\nah sil\n")
    net = os.path.join(d, "net")
    text, rc = _stdout(m.main, [phones, net])
    return text.replace(d, ""), rc, _read(net)


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
    "htk_hmm": (case_htk_hmm, t_htk_hmm, j_htk_hmm),
    "slf": (case_slf, t_slf, j_slf),
    "dictionary": (case_dictionary, t_dictionary, j_dictionary),
    "lattice_expand": (case_lattice_expand, t_lattice_expand, j_lattice_expand),
    "mpe_native": (case_mpe_native, t_mpe_native, j_mpe_native),
    "gen_gmmbypass": (case_gen_gmmbypass, t_gen_gmmbypass, j_gen_gmmbypass),
    "mpe_numpy": (_case_mpe("numpy"), t_mpe, j_mpe),
    "mpe_native_engine": (_case_mpe("native"), t_mpe, j_mpe),
    "wav": (case_wav, t_wav, j_wav),
    "mfcc": (case_mfcc, t_mfcc, j_mfcc),
    "thcopy": (case_thcopy, t_thcopy, j_thcopy),
    "tjoiner": (case_tjoiner, t_tjoiner, j_tjoiner),
    "tsegmenter": (case_tsegmenter, t_tsegmenter, j_tsegmenter),
    "sresults": (case_sresults, t_sresults, j_sresults),
    "gen_phone_loop": (case_gen_phone_loop, t_gen_phone_loop, j_gen_phone_loop),
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


def test_mpe_library_is_the_ports_own():
    """The port builds its own copy of mpefb.cc into its own cache, beside
    its htkio library, and loads that one."""
    pkg = os.path.realpath(os.path.dirname(os.path.dirname(t_mpe_native.__file__)))
    assert os.path.realpath(t_mpe_native._source_path()).startswith(pkg)
    assert t_mpe_native.CACHE_DIR == t_native.CACHE_DIR
    if t_mpe_native.available():
        assert os.path.realpath(t_mpe_native.get_lib()._name).startswith(
            os.path.realpath(t_native.CACHE_DIR))
    with open(t_mpe_native._source_path()) as f:
        port_src = f.read()
    with open(j_mpe_native._source_path()) as f:
        orig_src = f.read()
    # the copy adds a note under the first line and changes no line of code
    assert port_src.endswith(orig_src.split("\n", 1)[1])
