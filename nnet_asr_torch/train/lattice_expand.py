"""Word-lattice → phone-lattice expansion for MPE sequence training.

Replaces DecoderNetwork::ExpansionsAndOptimizations' word expansion
(TMpeCu.cc:535-544, STKLib ExpandByDictionary at
STKLib/trunk/src/STKLib/DecoderNetwork.cc:129-326): each word arc whose
label has dictionary pronunciations is replaced by one phone chain per
pronunciation variant, phone nodes inheriting the word arc's time span
(DecoderNetwork.cc:222-231) and the incoming/outgoing scores attaching to
the chain ends (DecoderNetwork.cc:293-312).

The port's copy of ``nnet_asr_tpu/train/lattice_expand.py``, behaviour unchanged.

Two segmentation modes:

``segmentation="map"`` (default): STK's token-passing decoder explores
ALL phone segmentations inside the word span at decode time — phone
nodes carry no intra-word times. Our MPE engine factorizes into
within-arc FB × lattice FB over *timed* arcs (train/mpe.py), so this
mode fixes intra-word phone boundaries with a composite-HMM Viterbi
alignment against the same kappa-scaled posteriors the MPE pass uses —
the Kaldi-style "alignment lattice" formulation (the segmentation
integral approximated by its mode; docs/DEVIATIONS.md §3a).

``segmentation="exact"``: closes that deviation. Each word arc expands
into a BOUNDARY SUB-LATTICE — one node per feasible (phone boundary,
time) pair, one arc per phone occupation of every feasible span — so
the lattice-level forward-backward integrates over all intra-word
segmentations and each timed arc's within-arc FB integrates over state
paths given the boundaries: together the exact sum STK's token passing
computes (Decoder.tcc:2443-2578). Arc count grows O(k·span²) per word
arc; ``exact_window=W`` optionally restricts boundary times to ±W
frames around the MAP boundary (W=None: fully exact).

Pronunciation variants all expand in parallel (RESPECTPRONVARS semantics
when ``multiple_pronun``); the variant's log pronunciation probability
(scaled by PRONUNSCALE) and the word insertion penalty ride on the first
phone arc's ``prior`` field, which the MPE scorer adds unscaled —
mirroring mPronScale/mWPenalty entering the token score at word starts
(Decoder.tcc token passing).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..io.dictionary import Pronun
from ..io.htk_hmm import Hmm
from ..io.slf import Lattice, LatticeArc, LatticeNode

LOG_ZERO = -1e30

NULL_WORDS = ("!NULL", "<s>", "</s>")


@dataclass
class CompositeHmm:
    """Concatenation of phone HMMs into one left-to-right prob model.

    ``entry``: entry→state probs; ``trans``: state→state; ``exit``:
    state→exit; ``tee``: entry→exit; ``phone_of_state[i]``: index into the
    phone chain; ``senones[i]``: label-map senone id of state i.
    """
    entry: np.ndarray
    trans: np.ndarray
    exit: np.ndarray
    tee: float
    phone_of_state: np.ndarray
    senones: np.ndarray


def compose_hmms(hmms: Sequence[Hmm], senone_ids: Sequence[Sequence[int]]
                 ) -> CompositeHmm:
    """Sequential HMM concatenation (exit of phone p feeds entry of p+1,
    tee probabilities chain through)."""
    e = np.zeros((0,))
    A = np.zeros((0, 0))
    x = np.zeros((0,))
    tee = 1.0
    phone_of_state: List[int] = []
    senones: List[int] = []
    for p, (h, ids) in enumerate(zip(hmms, senone_ids)):
        S = h.n_emitting
        tp = h.transp
        e_p = tp[0, 1:S + 1]
        A_p = tp[1:S + 1, 1:S + 1]
        x_p = tp[1:S + 1, S + 1]
        tee_p = float(tp[0, S + 1])
        n_old = A.shape[0]
        A_new = np.zeros((n_old + S, n_old + S))
        A_new[:n_old, :n_old] = A
        A_new[:n_old, n_old:] = np.outer(x, e_p)
        A_new[n_old:, n_old:] = A_p
        e = np.concatenate([e, tee * e_p])
        x = np.concatenate([x * tee_p, x_p])
        A = A_new
        tee *= tee_p
        phone_of_state.extend([p] * S)
        senones.extend(ids)
    return CompositeHmm(entry=e, trans=A, exit=x, tee=tee,
                        phone_of_state=np.asarray(phone_of_state, np.int32),
                        senones=np.asarray(senones, np.int32))


def min_duration(hmm: Hmm) -> int:
    """Shortest emitting-frame count entry→exit over positive transitions
    (Dijkstra; self-loops are fine — costs are non-negative). Tee paths
    clamp to 1: zero-length phone arcs are not representable in the
    timed-arc engine."""
    import heapq

    tp = hmm.transp
    n = tp.shape[0]                       # S + 2
    INF = 10 ** 9
    dist = [INF] * n
    dist[0] = 0
    heap = [(0, 0)]
    while heap:
        dd, u = heapq.heappop(heap)
        if dd > dist[u]:
            continue
        for v in range(n):
            if tp[u, v] > 0:
                c = dd + (1 if 1 <= v <= n - 2 else 0)
                if c < dist[v]:
                    dist[v] = c
                    heapq.heappush(heap, (c, v))
    return max(1, dist[n - 1] if dist[n - 1] < INF else 1)


def viterbi_segment(comp: CompositeHmm, log_obs: np.ndarray,
                    transp_scale: float = 1.0
                    ) -> Optional[Tuple[float, np.ndarray]]:
    """MAP state path through the composite over ``log_obs`` (T, n_states)
    emissions. Returns (log score, state path (T,)) or None if no complete
    path exists (e.g. fewer frames than the minimum duration).
    ``transp_scale`` multiplies the log transition probs (TRANSPSCALE)."""
    T, N = log_obs.shape
    with np.errstate(divide="ignore"):
        le = transp_scale * np.where(
            comp.entry > 0, np.log(np.maximum(comp.entry, 1e-300)), LOG_ZERO)
        lA = transp_scale * np.where(
            comp.trans > 0, np.log(np.maximum(comp.trans, 1e-300)), LOG_ZERO)
        lx = transp_scale * np.where(
            comp.exit > 0, np.log(np.maximum(comp.exit, 1e-300)), LOG_ZERO)
    alpha = le + log_obs[0]
    back = np.zeros((T, N), np.int32)
    for t in range(1, T):
        cand = alpha[:, None] + lA           # (from, to)
        back[t] = np.argmax(cand, axis=0)
        alpha = cand[back[t], np.arange(N)] + log_obs[t]
        alpha = np.maximum(alpha, LOG_ZERO)
    final = alpha + lx
    best = int(np.argmax(final))
    score = float(final[best])
    if score <= LOG_ZERO / 2:
        return None
    path = np.empty(T, np.int32)
    path[T - 1] = best
    for t in range(T - 1, 0, -1):
        path[t - 1] = back[t, path[t]]
    return score, path


class LatticeExpander:
    """Expands word arcs of a lattice into timed phone chains."""

    def __init__(self, hmms: Dict[str, Hmm], label_map: Dict[str, int],
                 dictionary: Dict[str, List[Pronun]],
                 outprb_scale: float = 1.0, pron_scale: float = 1.0,
                 word_penalty: float = 0.0, frame_rate: float = 100.0,
                 multiple_pronun: bool = True,
                 segmentation: str = "map",
                 exact_window: Optional[int] = None,
                 transp_scale: float = 1.0):
        if segmentation not in ("map", "exact"):
            raise ValueError(f"segmentation must be 'map' or 'exact', "
                             f"got {segmentation!r}")
        self.hmms = hmms
        self.dictionary = dictionary
        self.outprb_scale = outprb_scale
        self.pron_scale = pron_scale
        self.word_penalty = word_penalty
        self.frame_rate = frame_rate
        self.multiple_pronun = multiple_pronun
        self.segmentation = segmentation
        self.exact_window = exact_window
        self.transp_scale = transp_scale
        self._senone_ids = {
            name: h.senone_ids(label_map) for name, h in hmms.items()}
        self._composites: Dict[Tuple[str, ...], CompositeHmm] = {}
        self._min_dur: Dict[str, int] = {}

    def _mindur(self, phone: str) -> int:
        d = self._min_dur.get(phone)
        if d is None:
            d = min_duration(self.hmms[phone])
            self._min_dur[phone] = d
        return d

    def needs_expansion(self, lat: Lattice) -> bool:
        return any((w := lat.arc_word(a)) is not None
                   and w not in NULL_WORDS and w not in self.hmms
                   and w in self.dictionary
                   for a in lat.arcs)

    def _composite(self, phones: Tuple[str, ...]) -> CompositeHmm:
        comp = self._composites.get(phones)
        if comp is None:
            comp = compose_hmms([self.hmms[p] for p in phones],
                                [self._senone_ids[p] for p in phones])
            self._composites[phones] = comp
        return comp

    def _align(self, phones: Tuple[str, ...], t0: int, t1: int,
               log_post: np.ndarray) -> Optional[List[Tuple[str, int, int]]]:
        """Viterbi phone boundaries inside [t0, t1); None if infeasible."""
        comp = self._composite(phones)
        obs = self.outprb_scale * log_post[t0:t1][:, comp.senones]
        res = viterbi_segment(comp, obs, self.transp_scale)
        if res is None:
            return None
        _, path = res
        seq = comp.phone_of_state[path]          # phone index per frame
        segs: List[Tuple[str, int, int]] = []
        f = 0
        T = len(seq)
        while f < T:
            g = f
            while g < T and seq[g] == seq[f]:
                g += 1
            segs.append((phones[int(seq[f])], t0 + f, t0 + g))
            f = g
        return segs

    def _expand_exact(self, a, phones: Tuple[str, ...], prior: float,
                      t0: int, t1: int, out: Lattice,
                      log_post: np.ndarray) -> bool:
        """Boundary sub-lattice for one (word arc, pronunciation): node
        (i, t) = "phones[:i] end exactly at frame t"; arc = phone i
        occupying [s, t). Every path start→end picks k boundary times, so
        the downstream lattice FB sums over ALL segmentations; min
        durations bound the feasible boundary ranges. Returns False when
        the span can't fit the pronunciation (that variant dies, as its
        tokens would in STK)."""
        k = len(phones)
        d = [self._mindur(p) for p in phones]
        if t1 - t0 < sum(d):
            return False
        # feasible range of boundary i (end frame of phones[:i]), 1..k-1
        lo = [t0 + sum(d[:i]) for i in range(1, k)]
        hi = [t1 - sum(d[i:]) for i in range(1, k)]
        if self.exact_window is not None and k > 1:
            segs = self._align(phones, t0, t1, log_post)
            if segs is None:
                return False
            map_b = [f1 for (_, _, f1) in segs[:-1]]
            lo = [max(l, b - self.exact_window)
                  for l, b in zip(lo, map_b)]
            hi = [min(h, b + self.exact_window)
                  for h, b in zip(hi, map_b)]
            # arc-consistency along the boundary chain so no (i, t) node
            # is left without a feasible predecessor or successor (a
            # dead-end node would masquerade as a lattice start/end node
            # in the downstream FB)
            for j in range(1, k - 1):
                lo[j] = max(lo[j], lo[j - 1] + d[j])
            for j in range(k - 3, -1, -1):
                hi[j] = min(hi[j], hi[j + 1] - d[j + 1])
            if any(l > h for l, h in zip(lo, hi)):
                return False
        # one private node per (boundary, time): variants never share
        # internal nodes (sharing would create cross-variant paths)
        node_id = {}
        for i in range(1, k):
            for t in range(lo[i - 1], hi[i - 1] + 1):
                out.nodes.append(LatticeNode(
                    time=t / self.frame_rate, word=None))
                node_id[(i, t)] = len(out.nodes) - 1
        for i in range(1, k + 1):
            starts = ([(a.start, t0)] if i == 1 else
                      [(node_id[(i - 1, s)], s)
                       for s in range(lo[i - 2], hi[i - 2] + 1)])
            ends = ([(a.end, t1)] if i == k else
                    [(node_id[(i, t)], t)
                     for t in range(lo[i - 1], hi[i - 1] + 1)])
            for sn, s in starts:
                for en, t in ends:
                    if t - s < d[i - 1]:
                        continue
                    out.arcs.append(LatticeArc(
                        start=sn, end=en, word=phones[i - 1],
                        acoustic=a.acoustic if i == k else 0.0,
                        lm=a.lm if i == 1 else 0.0,
                        prior=prior if i == 1 else 0.0))
        return True

    def expand(self, lat: Lattice, log_post: np.ndarray) -> Lattice:
        """Word arcs → timed phone chains (phone/NULL arcs pass through).

        Arcs whose word has no dictionary entry and no HMM raise (like
        STK's WORD_NOT_IN_DIC_WARN followed by the decoder failing on the
        unexpanded word node); pronunciation variants that cannot fit the
        arc's time span are dropped — if all variants of an arc drop, the
        arc is removed (that path dies, as its tokens would in STK).
        """
        T = log_post.shape[0]
        out = Lattice(header=dict(lat.header))
        # node words move onto arcs (arc_word falls back to end nodes)
        out.nodes = [LatticeNode(time=n.time, word=None) for n in lat.nodes]

        def frame(i):
            return min(lat.frame(i, self.frame_rate), T)

        for a in lat.arcs:
            word = lat.arc_word(a)
            if (word is None or word in NULL_WORDS or word in self.hmms
                    or word not in self.dictionary):
                out.arcs.append(LatticeArc(
                    start=a.start, end=a.end, word=word,
                    acoustic=a.acoustic, lm=a.lm, prior=a.prior))
                continue
            t0, t1 = frame(a.start), frame(a.end)
            pronuns = self.dictionary[word]
            if not self.multiple_pronun:
                pronuns = pronuns[:1]
            expanded_any = False
            for pronun in pronuns:
                prior = (a.prior + self.pron_scale * pronun.log_prob
                         + self.word_penalty)
                if not pronun.phones:
                    # empty pronunciation: the word becomes a NULL arc
                    out.arcs.append(LatticeArc(
                        start=a.start, end=a.end, word=None,
                        acoustic=a.acoustic, lm=a.lm, prior=prior))
                    expanded_any = True
                    continue
                if self.segmentation == "exact":
                    if t1 > t0 and self._expand_exact(
                            a, pronun.phones, prior, t0, t1, out, log_post):
                        expanded_any = True
                    continue
                segs = self._align(pronun.phones, t0, t1, log_post) \
                    if t1 > t0 else None
                if segs is None:
                    continue
                prev = a.start
                for k, (ph, f0, f1) in enumerate(segs):
                    last = k == len(segs) - 1
                    if last:
                        nxt = a.end
                    else:
                        out.nodes.append(LatticeNode(
                            time=f1 / self.frame_rate, word=None))
                        nxt = len(out.nodes) - 1
                    out.arcs.append(LatticeArc(
                        start=prev, end=nxt, word=ph,
                        acoustic=a.acoustic if last else 0.0,
                        lm=a.lm if k == 0 else 0.0,
                        prior=prior if k == 0 else 0.0))
                    prev = nxt
                expanded_any = True
            if not expanded_any:
                import sys
                print(f"WARNING: no pronunciation of '{word}' fits "
                      f"frames [{t0},{t1}) — dropping arc", file=sys.stderr)
        out.topo_check()
        return out
