"""The port's MPE device engine (``ops/mpe_device.py``, torch) against the
JAX package's (``ops/mpe_device.py``, ``lax.scan``), on the CPU.

The masked recursions run in their inputs' dtype: fed the same float32
inputs as JAX, log-likelihoods agree within 1e-5 absolute and occupancies
within 1e-6. The host-array wrappers compute in float64 where JAX casts
to float32: the same tolerances hold against JAX, and the port's own
numpy engine agrees with its device engine through ``MpeComputer`` within
1e-6 on the gammas, as does JAX's ``MpeComputer(engine="jax")``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnet_asr_torch.io.htk_hmm import Hmm as THmm
from nnet_asr_torch.io.slf import Lattice as TLattice, LatticeArc as TArc, LatticeNode as TNode
from nnet_asr_torch.ops import mpe_device as T
from nnet_asr_torch.train import mpe as tmpe
from nnet_asr_tpu.io.htk_hmm import Hmm as JHmm
from nnet_asr_tpu.io.slf import Lattice as JLattice, LatticeArc as JArc, LatticeNode as JNode
from nnet_asr_tpu.ops import mpe_device as J
from nnet_asr_tpu.train import mpe as jmpe

torch.set_num_threads(2)

LOG_ZERO = -1e30


def _log_tp(rng, A, S, skip=False):
    """(A, S+2, S+2) log transitions of left-to-right HMMs (with skips
    from the entry state when ``skip``)."""
    tp = np.zeros((A, S + 2, S + 2))
    for a in range(A):
        tp[a, 0, 1] = 1.0
        if skip and S > 1:
            tp[a, 0, 1], tp[a, 0, 2] = 0.6, 0.4
        for i in range(1, S + 1):
            p = rng.uniform(0.2, 0.8)
            tp[a, i, i], tp[a, i, i + 1] = p, 1.0 - p
    with np.errstate(divide="ignore"):
        return np.where(tp > 0, np.log(np.maximum(tp, 1e-300)), LOG_ZERO)


def _dead_equal(want, got):
    """Arcs without a path carry LOG_ZERO in both (-1e30 rounds to another
    value in float32)."""
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    dead = want <= LOG_ZERO / 2
    np.testing.assert_array_equal(got <= LOG_ZERO / 2, dead)
    return want[~dead], got[~dead]


@pytest.mark.parametrize("A,Lp,S,skip", [(1, 1, 1, False), (1, 6, 3, False),
                                         (5, 7, 3, True), (8, 1, 2, False),
                                         (6, 9, 2, False), (12, 5, 1, False)])
def test_masked_recursions_match_jax(A, Lp, S, skip):
    rng = np.random.default_rng(A * 100 + Lp * 10 + S)
    obs = rng.standard_normal((A, Lp, S)).astype(np.float32)
    lt = _log_tp(rng, A, S, skip).astype(np.float32)
    lens = rng.integers(1, Lp + 1, A)
    lens[0] = Lp
    jll, jocc = J.arc_fb_masked(jnp.asarray(obs), jnp.asarray(lt), jnp.asarray(lens, jnp.int32))
    targs = (torch.from_numpy(obs), torch.from_numpy(lt), torch.from_numpy(lens))
    tll, tocc = T.arc_fb_masked(*targs)
    np.testing.assert_allclose(tll.numpy(), np.asarray(jll), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tocc.numpy(), np.asarray(jocc), rtol=0, atol=1e-6)
    jf = J.arc_fwd_masked(jnp.asarray(obs), jnp.asarray(lt), jnp.asarray(lens, jnp.int32))
    np.testing.assert_allclose(T.arc_fwd_masked(*targs).numpy(), np.asarray(jf), rtol=0,
                               atol=1e-5)
    # past each arc's end the occupancy is zero
    for a, n in enumerate(lens):
        assert not tocc[a, n:].any()


@pytest.mark.parametrize("S", [1, 2, 3])
def test_padded_wrappers_match_jax(S):
    rng = np.random.default_rng(S)
    lens = [1, 2, 3, 5, 8, 4, 13, 3][:6 + S]
    obs = [rng.standard_normal((n, S)) for n in lens]
    lts = list(_log_tp(rng, len(lens), S))
    jll, jocc = J.arc_fb_padded_jax(obs, lts)
    tll, tocc = T.arc_fb_padded(obs, lts, device="cpu")
    np.testing.assert_allclose(*_dead_equal(jll, tll), rtol=0, atol=1e-5)
    for jo, to, n in zip(jocc, tocc, lens):
        assert to.shape == (n, S) and to.dtype == np.float64
        np.testing.assert_allclose(to, jo, rtol=0, atol=1e-6)
    jf = J.arc_fwd_padded_jax(obs, lts)
    tf = T.arc_fwd_padded(obs, lts, device="cpu")
    np.testing.assert_allclose(*_dead_equal(jf, tf), rtol=0, atol=1e-5)
    np.testing.assert_allclose(*_dead_equal(tll, tf), rtol=0, atol=1e-12)


def test_unmasked_pair_matches_jax_and_the_host_engine():
    rng = np.random.default_rng(12)
    obs = rng.standard_normal((4, 5, 3))
    lt = _log_tp(rng, 4, 3)
    ll, occ = T.arc_forward_backward_batch(obs, lt, device="cpu")
    jll, jocc = J.arc_forward_backward_batch_jax(obs, lt)
    np.testing.assert_allclose(ll, jll, rtol=0, atol=1e-5)
    np.testing.assert_allclose(occ, jocc, rtol=0, atol=1e-6)
    hll, hocc = tmpe.arc_forward_backward_batch(obs, lt)
    np.testing.assert_allclose(ll, hll, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(occ, hocc, rtol=0, atol=1e-12)
    fwd = T.arc_forward_batch(obs, lt, device="cpu")
    np.testing.assert_allclose(fwd, J.arc_forward_batch_jax(obs, lt), rtol=0, atol=1e-5)
    np.testing.assert_allclose(fwd, tmpe.arc_forward_batch(obs, lt), rtol=1e-12, atol=1e-12)


def _hmm(cls, name, n_emit=1, self_loop=0.5):
    n = n_emit + 2
    tp = np.zeros((n, n))
    tp[0, 1] = 1.0
    for i in range(1, n - 1):
        tp[i, i], tp[i, i + 1] = self_loop, 1.0 - self_loop
    return cls(name=name, n_states=n, transp=tp,
               state_names=[f"{name}_s{i + 2}" for i in range(n_emit)])


LABEL_MAP = {"a_s2": 0, "a_s3": 1, "b_s2": 2, "c_s2": 3, "c_s3": 4, "c_s4": 5}
# a diamond with a !NULL arc and same-time nodes: (start, end, phone, lm)
ARCS = [(0, 1, "a", -0.3), (0, 2, "b", -0.1), (1, 3, "c", 0.0), (2, 3, "b", -0.2),
        (3, 4, "!NULL", 0.0), (4, 5, "a", 0.0), (4, 5, "c", -0.5), (0, 1, "c", -1.0)]
TIMES = [0.0, 0.07, 0.07, 0.10, 0.10, 0.16]
REF = [(0, 7, "a"), (7, 10, "b"), (10, 16, "c")]


def _both(pkg):
    """(hmms, lattice) built from one package's classes."""
    Hmm, Lattice, Arc, Node = ((THmm, TLattice, TArc, TNode) if pkg == "torch"
                               else (JHmm, JLattice, JArc, JNode))
    hmms = {"a": _hmm(Hmm, "a", 2, 0.3), "b": _hmm(Hmm, "b"), "c": _hmm(Hmm, "c", 3, 0.6)}
    lat = Lattice(nodes=[Node(time=t) for t in TIMES],
                  arcs=[Arc(start=s, end=e, word=w, lm=lm) for s, e, w, lm in ARCS])
    return hmms, lat


@pytest.mark.parametrize("cfg,kw", [
    ({}, {}),
    ({"outprb_scale": 0.3}, {}),
    ({"ml_gamma": True}, {}),
    ({"occup_scale": 0.7, "ml_gamma": True}, {}),
    ({"transp_scale": 2.0, "model_penalty": -1.5}, {}),
    ({}, {"utt_weight": 0.6, "frame_weights": np.linspace(0.5, 1.5, 16)}),
    ({}, {"pruning": 1e6}),                        # the prune-then-occupancy path
    ({"ml_gamma": True}, {"pruning": 3.0}),
], ids=["default", "kappa", "ml", "ocp", "transp_penalty", "weights", "wide_beam",
        "tight_beam"])
def test_mpe_computer_device_engine_matches_jax_and_numpy(cfg, kw):
    log_post = np.log(np.random.default_rng(21).dirichlet(np.ones(6), size=16)).astype(np.float32)
    th, tlat = _both("torch")
    jh, jlat = _both("jax")
    dev = tmpe.MpeComputer(th, LABEL_MAP, tmpe.MpeConfig(**cfg), engine="jax", device="cpu")
    g_dev, c_dev, z_dev = dev.compute(tlat, log_post, REF, **kw)
    g_np, c_np, z_np = tmpe.MpeComputer(th, LABEL_MAP, tmpe.MpeConfig(**cfg),
                                        engine="numpy").compute(tlat, log_post, REF, **kw)
    g_jx, c_jx, z_jx = jmpe.MpeComputer(jh, LABEL_MAP, jmpe.MpeConfig(**cfg),
                                        engine="jax").compute(jlat, log_post, REF, **kw)
    assert np.abs(g_dev).max() > 0
    np.testing.assert_allclose(g_dev, g_np, rtol=0, atol=1e-6)
    np.testing.assert_allclose(g_dev, g_jx, rtol=0, atol=1e-6)
    assert c_dev == pytest.approx(c_np, abs=1e-9) and z_dev == pytest.approx(z_np, abs=1e-9)
    assert c_dev == pytest.approx(c_jx, abs=1e-6) and z_dev == pytest.approx(z_jx, abs=1e-4)


def test_device_engine_defaults_to_the_card():
    """engine="jax" resolves its device like every entry point: cuda:0
    unless told otherwise, and no quiet fall back to the CPU."""
    hmms, _ = _both("torch")
    if torch.cuda.is_available():
        comp = tmpe.MpeComputer(hmms, LABEL_MAP, tmpe.MpeConfig(), engine="jax")
        assert comp._arc_fb_padded.keywords["device"] == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmpe.MpeComputer(hmms, LABEL_MAP, tmpe.MpeConfig(), engine="jax")
