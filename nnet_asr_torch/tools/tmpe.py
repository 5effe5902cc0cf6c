"""TMpe — MPE/sMBR lattice sequence-training CLI on one CUDA device (port
of nnet_asr_tpu/tools/tmpe.py, TMpeCu.cc, SNAME "TMPECU").

Per utterance (TMpeCu.cc:461-672): the transform and the net's forward on
the device (``train/trainer.py`` ``forward_body``: every BiasedLinearity →
Sigmoid pair through the ``affine_sigmoid`` kernel) → f32 log posteriors
to the host → lattice forward-backward with MPE accuracy statistics
(``train/mpe.py``) → ``err = -OUTPSCALE * gamma_mpe`` back to the device →
the gradient of ``sum(logits * err)`` (the softmax-identity backward of
the reference) through a second forward with autograd → ``apply_updates``
(momentum 0). ``--MLGAMMA`` accumulates plain ML occupancies, ``--MMI``
takes ``err = -kappa * (onehot(alignment) - gamma_den)``. Lattices come
from ``--LATTICEDIR/--LATTICEEXT`` as SLF files or an MLF of them, the
reference phone segmentation from the ``-I`` state-label MLF.

The option vocabulary and the log lines are the JAX tool's. The device
comes from ``--GPUSELECT`` (-1 means ``cuda:0``) and the run raises without
CUDA; only ``main(argv, device="cpu")`` runs on the CPU, through the
kernels' plain versions. ``--MPEENGINE=jax`` names the port's torch device
engine (``ops/mpe_device.py``); ``auto`` takes the native engine if g++
built it, else numpy, and on a CUDA device measures the device engine
against it on the first utterance. ``--MESH`` is not ported yet.

    python -m nnet_asr_torch.tools.tmpe -H nn.mmf --HMM=hmms.mmf \\
        -I labs.mlf -L '*/' -X lab -m label_map -S train.scp \\
        --LATTICEDIR=lats --OUTPSCALE=0.3 --LEARNINGRATE=0.02 \\
        --TARGETMMF=nn_mpe1.mmf
"""

from __future__ import annotations

import copy
import sys
import threading
import time

import numpy as np
import torch

from .. import __version__
from ..device import DeviceLike, gpuselect_device, resolve_device
from ..io.htk_hmm import parse_mmf
from ..io.labels import LabelRepository
from ..io.scp import parse_scp_entry, read_scp
from ..io.slf import LatticeArchive
from ..models.components import Softmax
from ..models.network import Network
from ..train.mpe import MpeComputer, MpeConfig, labels_to_phone_segments
from ..train.pipeline import TransformPipeline
from ..train.sgd import SgdConfig, apply_updates, init_momentum, layer_lr_factors
from ..train.trainer import forward_body
from ..utils.config import UserInterface
from ..utils.prefetch import prefetch_map
from . import not_ported


def _fb_worker_init(hmm_path, label_map, cfg, engine):
    """Per-process MpeComputer for the -c FB pool (module-level so it
    pickles; each worker parses the HMM set once)."""
    global _FB_MPE
    _FB_MPE = MpeComputer(parse_mmf(hmm_path), label_map, cfg, engine=engine)


def _fb_one(lat, log_post, segs, weight, outprb_scale, thresh, prn_step, prn_limit):
    """One utterance's FB with the widen-and-retry loop; returns avg_acc
    or None (skip)."""
    mpe = _FB_MPE
    mpe.cfg.outprb_scale = outprb_scale
    while True:
        try:
            _, avg_acc, _ = mpe.compute(lat, log_post, segs, utt_weight=weight,
                                        pruning=thresh)
            return avg_acc
        except FloatingPointError:
            if thresh <= 0.0:
                raise
            if prn_step <= 0.0 or thresh + prn_step > prn_limit:
                return None
            thresh += prn_step


OPTION_STRING = (
    " -c n   CROSSVALIDATE=TRUE"
    " -m r   OUTPUTLABELMAP"
    " -n r   LEARNINGRATE"
    " -D n   PRINTCONFIG=TRUE"
    " -H l   SOURCEMMF"
    " -I r   SOURCEMLF"
    " -L r   SOURCETRANSCDIR"
    " -S l   SCRIPT"
    " -T r   TRACE"
    " -t ror PRUNING PRUNINGINC PRUNINGMAX"
    " -V n   PRINTVERSION=TRUE"
    " -X r   SOURCETRANSCEXT"
)

SNAME = "TMPECU"


def main(argv=None, device: DeviceLike = None) -> int:
    """Run the tool. ``device`` overrides ``--GPUSELECT`` (the tests pass "cpu")."""
    argv = list(sys.argv if argv is None else argv)
    ui = UserInterface()
    args_parsed = ui.parse_options(argv, OPTION_STRING, SNAME)

    reader, feaparams = ui.make_feature_reader()
    p_hmm = ui.get_str("HMM")
    p_mlf = ui.get_str("SOURCEMLF")
    p_label_map = ui.get_str("OUTPUTLABELMAP")
    p_lbl_dir = ui.get_str("SOURCETRANSCDIR")
    p_lbl_ext = ui.get_str("SOURCETRANSCEXT", "lab")
    p_lat_dir = ui.get_str("LATTICEDIR")
    p_lat_ext = ui.get_str("LATTICEEXT", "lat")
    p_net_filter = ui.get_str("HNETFILTER")   # TMpeCu.cc:288-290
    p_source_mmf = ui.get_str("SOURCEMMF")
    p_transform = ui.get_str("FEATURETRANSFORM")
    p_targetmmf = ui.get_str("TARGETMMF")
    p_script = ui.get_str("SCRIPT")
    outprb_scale = ui.get_flt("OUTPSCALE", 1.0)
    lm_scale = ui.get_flt("LMSCALE", 1.0)
    learning_rate = ui.get_flt("LEARNINGRATE", 0.06)
    lr_factors = ui.get_str("LEARNRATEFACTORS", None)
    weightcost = ui.get_flt("WEIGHTCOST", 0.0)
    grad_div_frm = ui.get_bool("GRADDIVFRM", True)
    ml_gamma = ui.get_bool("MLGAMMA", False)
    state_pruning = ui.get_flt("PRUNING", 0.0)
    stprn_step = ui.get_flt("PRUNINGINC", 0.0)
    stprn_limit = ui.get_flt("PRUNINGMAX", 0.0)
    nframeoutpnorm = ui.get_bool("NFRAMEOUTPNORM", False)
    # word-lattice expansion (TMpeCu.cc:254-282, 535-544): a dictionary
    # turns word arcs into aligned phone chains (train/lattice_expand.py)
    p_dict = ui.get_str("SOURCEDICT")
    pron_scale = ui.get_flt("PRONUNSCALE", 1.0)
    word_penalty = ui.get_flt("WORDPENALTY", 0.0)
    respect_pronvars = ui.get_bool("RESPECTPRONVARS", False)
    # integrate over ALL intra-word segmentations (STK-exact) instead of
    # MAP Viterbi boundaries; EXACTSEGWINDOW=W bounds boundary times to
    # ±W frames of the MAP boundary (0 = fully exact)
    exact_seg = ui.get_bool("EXACTSEGMENTATION", False)
    exact_window = ui.get_int("EXACTSEGWINDOW", 0) or None
    # decoder scale/penalty knobs (TMpeCu.cc:256-267)
    transp_scale = ui.get_flt("TRANSPSCALE", 1.0)
    model_penalty = ui.get_flt("MODELPENALTY", 0.0)
    occup_scale = ui.get_flt("OCCUPPSCALE", 1.0)
    start_time_shift = ui.get_flt("STARTTIMESHIFT", 0.0)
    end_time_shift = ui.get_flt("ENDTIMESHIFT", 0.0)
    # STK recognition-network construction/beam knobs with no analog in
    # the factorized SLF engine: accepted for script compatibility, must
    # stay at the reference defaults (TMpeCu.cc:262-283). The lattices
    # are always timed, so TIMEPRUNING's "ignore lattice times" default
    # is structurally n/a.
    ui.get_bool("TIMEPRUNING", False)
    for flag, default in (("ALLOWXWRDEXP", False), ("EXACTTIMEMERGE", False),
                          ("REMEXPWRDNODES", False), ("MINIMIZENET", False),
                          ("WEIGHTPUSHING", True)):
        if ui.get_bool(flag, default) != default:
            print(f"WARNING: --{flag} has no effect: the factorized SLF "
                  f"engine builds no STK recognition network "
                  f"(docs/DEVIATIONS.md §2/§3)", file=sys.stderr)
    for flag in ("MAXACTIVEMODELS", "MINACTIVEMODELS"):
        if ui.get_int(flag, 0) != 0:
            print(f"WARNING: --{flag} has no effect: the exact lattice FB "
                  f"has no token beam; use --PRUNING* for the lattice "
                  f"beam", file=sys.stderr)
    if ui.get_flt("POSTERIORSCALE", 1.0) != 1.0:
        print("WARNING: --POSTERIORSCALE has no effect: SLF lattices carry "
              "no posterior field (STK-net 'P=' links only)",
              file=sys.stderr)
    # MMI mode: err = -kappa*(onehot(numerator alignment) - gamma_den^ML)
    # (the capability of TMmiCu, whose source the reference lacks)
    mmi = ui.get_bool("MMI", False)
    show_gamma = ui.get_bool("SHOWGAMMA", False)
    # evaluate the MPE criterion without updating; with no update
    # dependency the forwards run ``LOOKAHEAD`` utterances ahead of the
    # host lattice forward-backward
    crossval = ui.get_bool("CROSSVALIDATE", False)
    lookahead = ui.get_int("LOOKAHEAD", 8)
    # one-utterance-stale gradients: utterance u+1's forward is dispatched
    # BEFORE u's update, so it overlaps u's host lattice FB; one update of
    # staleness against the reference's strict sequential SGD
    delayed_update = ui.get_bool("DELAYEDUPDATE", False)
    # -c only: lattice FB on a process pool (evaluation has no update
    # dependency between utterances); 1 = serial
    fb_workers = ui.get_int("FBWORKERS", 1)
    mesh_spec = ui.get_str("MESH")
    mpe_engine = ui.get_enum("MPEENGINE", "auto", ["auto", "jax", "numpy", "native"])
    gpuselect = ui.get_int("GPUSELECT", -1)
    trace = ui.get_int("TRACE", 0)
    if ui.get_bool("PRINTCONFIG", False):
        ui.print_config()
    if ui.get_bool("PRINTVERSION", False):
        print(f"\n======= TMPECU v{__version__} (nnet_asr_torch) =======\n")
    ui.check_command_line_param_use()
    if mesh_spec:
        raise not_ported("--MESH", "queue 1 item 14")

    for req, msg in ((p_source_mmf, "Source MMF must be specified [-H]"),
                     (p_hmm, "HMM MMF must be specified [--HMM]"),
                     (p_mlf, "Source MLF missing [-I]"),
                     (p_label_map, "Output label map missing [-m]"),
                     (p_lat_dir, "Lattice dir missing [--LATTICEDIR]")):
        if req is None:
            raise SystemExit(msg)

    net = Network.read(p_source_mmf)
    if not isinstance(net.layers[-1], Softmax):
        raise SystemExit("MPE training expects a terminal <softmax>")
    dev = gpuselect_device(gpuselect) if device is None else resolve_device(device)
    net.to(dev)
    transform = Network.read(p_transform) if p_transform else None
    pipe = TransformPipeline(transform, feaparams["start_frm_ext"],
                             feaparams["end_frm_ext"], device=dev)
    labels_repo = LabelRepository(p_mlf, p_label_map, p_lbl_dir, p_lbl_ext)
    label_names = [None] * labels_repo.n_outputs
    for tag, idx in labels_repo.label_map.items():
        label_names[idx] = tag

    hmms = parse_mmf(p_hmm)
    # 'auto' on the card MEASURES instead of assuming: a one-utterance
    # probe below times the device engine against the host one
    probe_pending = False
    if mpe_engine == "auto":
        from ..train import mpe_native
        mpe_engine = "native" if mpe_native.available() else "numpy"
        if mpe_engine == "numpy":
            print("[MPEENGINE auto] the native engine did not build (g++): numpy",
                  file=sys.stderr)
        probe_pending = dev.type == "cuda"
    dictionary = None
    if p_dict:
        from ..io.dictionary import read_dictionary
        dictionary = read_dictionary(p_dict)
    mpe = MpeComputer(hmms, labels_repo.label_map,
                      MpeConfig(lm_scale=lm_scale, outprb_scale=outprb_scale,
                                ml_gamma=ml_gamma or mmi, pron_scale=pron_scale,
                                word_penalty=word_penalty,
                                respect_pronun_var=respect_pronvars,
                                exact_segmentation=exact_seg, exact_window=exact_window,
                                transp_scale=transp_scale, model_penalty=model_penalty,
                                occup_scale=occup_scale, start_time_shift=start_time_shift,
                                end_time_shift=end_time_shift),
                      engine=mpe_engine, dictionary=dictionary, device=dev)
    lattices = LatticeArchive(p_lat_dir, p_lat_ext, filter_cmd=p_net_filter)

    entries = read_scp(p_script) if p_script else []
    for extra in argv[args_parsed:]:
        entries.append(parse_scp_entry(extra))

    sgd_cfg = SgdConfig(learning_rate=learning_rate, weightcost=weightcost,
                        grad_div_frm=grad_div_frm,
                        lr_factors=SgdConfig.parse_factors(lr_factors))
    factors = tuple(layer_lr_factors(net, sgd_cfg))
    params = net.params
    velocity = init_momentum(net, sgd_cfg.momentum, sgd_cfg.velocity_dtype)
    body = list(net.layers)[:-1]
    trainable = [(i, k) for i, (spec, f) in enumerate(zip(net.layers, factors))
                 if spec.updatable and f != 0.0 for k in spec.trainable_keys]

    @torch.no_grad()
    def forward_logpost(feats):
        # no autograd graph: under --DELAYEDUPDATE the next utterance's
        # forward is queued before this utterance's in-place update
        return torch.log_softmax(forward_body(body, feats), dim=-1)

    def update(feats, err, n_frames):
        # backprop the externally-computed error through the logits
        # (softmax backward = identity, as the reference does)
        logits = forward_body(body, feats)
        ts = [params[i][k] for i, k in trainable]
        gs = torch.autograd.grad((logits * err).sum(), ts) if ts else []
        grads = [{} for _ in params]
        for (i, k), g in zip(trainable, gs):
            grads[i][k] = g
        apply_updates(net, params, velocity, grads, sgd_cfg, n_frames, factors)

    print(f"===== TMpe {'CROSSVALIDATION' if crossval else 'TRAINING'} "
          f"STARTED =====")
    t0 = time.time()
    frames = 0
    acc_sum = 0.0
    n_utts = 0
    t_read = 0.0      # prefetch wait (I/O not hidden by the pipeline)
    t_fwd = 0.0       # device forward dispatch + posterior fetch
    t_decode = 0.0    # host lattice forward-backward
    t_update = 0.0    # device update dispatch

    # ---- prefetch pipeline -------------------------------------------
    # Everything weight-INDEPENDENT per utterance (feature read, frame
    # labels, reference segmentation, lattice read+parse) runs on a reader
    # pool ahead of the training loop (the Platform reader-thread analog,
    # Platform.h:201-245). The weight-dependent work (forward, lattice FB
    # on the current posteriors, update) stays in order on this thread.
    # FeatureReader keeps per-read state -> one copy per worker thread;
    # MlfReader's seek+read is lock-atomic, so LatticeArchive.get is safe.
    tls = threading.local()
    s_ext = feaparams["start_frm_ext"]
    e_ext = feaparams["end_frm_ext"]

    def read_one(e):
        rd = getattr(tls, "reader", None)
        if rd is None:
            rd = tls.reader = copy.copy(reader)
        feats_ext = rd.read(e.physical, e.logical)
        T = feats_ext.shape[0] - s_ext - e_ext
        labs = labels_repo.get_frame_labels(T, rd.last_header.sample_period, e.logical)
        segs = labels_to_phone_segments(labs, label_names)
        lat = lattices.get(e.logical)
        # native engine: arc/phone flattening is weight-independent
        mpe.preflatten(lat)
        return e, feats_ext, T, labs, segs, lat

    def to_host(log_post_dev, T):
        return log_post_dev[:T].cpu().numpy()

    def lattice_fb(e, T, labs, segs, lat, log_post):
        """Per-utterance FB with the reference's widen-and-retry pruning
        loop (TMpeCu.cc:570-609); NFRAMEOUTPNORM divides the decoder-
        internal kappa and all thresholds by n_frames (the error scale
        keeps the original kappa, TMpeCu.cc:630). Returns (gammas|None,
        avg_acc)."""
        nonlocal mpe, probe_pending
        thresh, prn_step, prn_limit = state_pruning, stprn_step, stprn_limit
        mpe.cfg.outprb_scale = outprb_scale
        if nframeoutpnorm:
            mpe.cfg.outprb_scale = outprb_scale / T
            thresh /= T
            prn_step /= T
            prn_limit /= T
        gammas, avg_acc = None, 0.0
        while True:
            try:
                gammas, avg_acc, _ = mpe.compute(lat, log_post, segs, utt_weight=e.weight,
                                                 pruning=thresh)
                break
            except FloatingPointError:
                if thresh <= 0.0:
                    raise           # no pruning active: genuinely bad data
                if prn_step <= 0.0 or thresh + prn_step > prn_limit:
                    # the reference raises here despite the wording
                    # (TMpeCu.cc:600); with no beam left to widen the
                    # utterance is skipped instead of aborting the run
                    print(f"WARNING: Overpruning or bad data, skipping "
                          f"file {e.logical}", file=sys.stderr)
                    break
                thresh += prn_step
                print(f"WARNING: Overpruning or bad data in file "
                      f"{e.logical}, trying pruning threshold: {thresh:g}",
                      file=sys.stderr)
        if gammas is not None and probe_pending:
            # one-utterance engine probe: re-run this utterance's FB on
            # both engines and keep the faster one for the rest of the run
            probe_pending = False
            tn = time.time()
            mpe.compute(lat, log_post, segs, utt_weight=e.weight, pruning=thresh)
            tn = time.time() - tn
            dev_mpe = MpeComputer(hmms, labels_repo.label_map, mpe.cfg, engine="jax",
                                  dictionary=dictionary, device=dev)
            dev_mpe.compute(lat, log_post, segs, utt_weight=e.weight,
                            pruning=thresh)              # warm-up
            tj = time.time()
            dev_mpe.compute(lat, log_post, segs, utt_weight=e.weight, pruning=thresh)
            tj = time.time() - tj
            host_name = "native" if mpe._native is not None else "numpy"
            if tj < tn:
                mpe = dev_mpe
            print(f"[MPEENGINE auto] {host_name} {tn * 1e3:.1f}ms vs "
                  f"device {tj * 1e3:.1f}ms per utterance -> "
                  f"{'jax' if tj < tn else host_name}", flush=True)
        if show_gamma and gammas is not None:
            print(f"{e.logical}: avgAcc {avg_acc:.4f}")
        return gammas, avg_acc

    def consume(e, T, labs, segs, lat, log_post, feats):
        """FB + (in training mode) error backprop + update."""
        nonlocal frames, acc_sum, n_utts, t_decode, t_update
        td = time.time()
        gammas, avg_acc = lattice_fb(e, T, labs, segs, lat, log_post)
        t_decode += time.time() - td
        if gammas is None:
            return
        if not crossval:
            if mmi:
                # numerator = forced alignment one-hot; denominator = ML
                # occupancies of the lattice
                num = np.zeros_like(gammas)
                num[np.arange(T), labs] = 1.0
                gammas = num - gammas
            tu = time.time()
            err = torch.from_numpy((-outprb_scale * gammas).astype(np.float32)).to(dev)
            update(feats, err, T)
            t_update += time.time() - tu
        frames += T
        acc_sum += avg_acc
        n_utts += 1
        if trace & 2:
            print(".", end="", flush=True)

    if delayed_update and crossval:
        print("WARNING: --DELAYEDUPDATE has no effect with -c "
              "(evaluation already pipelines LOOKAHEAD deep)", file=sys.stderr)
    if fb_workers > 1 and (not crossval or dictionary is not None or show_gamma):
        print("WARNING: --FBWORKERS>1 applies to -c on plain phone "
              "lattices without --SHOWGAMMA (training is per-utterance "
              "sequential); running serial FB", file=sys.stderr)
        fb_workers = 1

    reads = prefetch_map(read_one, entries, workers=4, depth=max(2 * lookahead, 16))
    if crossval:
        # fixed params: dispatch up to ``lookahead`` forwards before the
        # first fetch, so the host FB overlaps the device's queued forwards.
        # With --FBWORKERS>1 the FB itself fans out over a process pool.
        from collections import deque
        pend = deque()
        pool = None
        fb_futures = []
        if fb_workers > 1:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            # spawn, not fork: this process runs prefetch threads (and
            # CUDA), which fork cannot carry; the workers run the numpy or
            # native engine only and never touch the card
            pool = ProcessPoolExecutor(
                max_workers=fb_workers, mp_context=multiprocessing.get_context("spawn"),
                initializer=_fb_worker_init,
                initargs=(p_hmm, labels_repo.label_map, mpe.cfg,
                          "native" if mpe._native is not None else "numpy"))

        def drain_one():
            nonlocal t_fwd
            e, T, labs, segs, lat, feats, dev_out = pend.popleft()
            tf = time.time()
            log_post = to_host(dev_out, T)
            t_fwd += time.time() - tf
            if pool is None:
                consume(e, T, labs, segs, lat, log_post, feats)
                return
            scale = outprb_scale
            th, st, lim = state_pruning, stprn_step, stprn_limit
            if nframeoutpnorm:
                scale = outprb_scale / T
                th, st, lim = th / T, st / T, lim / T
            # frames counted at result collection, not submit: a worker
            # may return None (overpruning skip)
            fb_futures.append((e.logical, T, pool.submit(
                _fb_one, lat, log_post, segs, e.weight, scale, th, st, lim)))

        try:
            for item in reads:
                tr = time.time()
                e, feats_ext, T, labs, segs, lat = item
                t_read += time.time() - tr
                feats, _ = pipe.transform_block([feats_ext])
                pend.append((e, T, labs, segs, lat, feats, forward_logpost(feats)))
                if len(pend) > lookahead:
                    drain_one()
            while pend:
                drain_one()
            if pool is not None:
                td = time.time()
                for name, T, fut in fb_futures:
                    avg_acc = fut.result()
                    if avg_acc is None:
                        print(f"WARNING: Overpruning or bad data, skipping "
                              f"file {name}", file=sys.stderr)
                        continue
                    frames += T
                    acc_sum += avg_acc
                    n_utts += 1
                    if trace & 2:
                        print(".", end="", flush=True)
                t_decode += time.time() - td
        finally:
            if pool is not None:
                pool.shutdown(cancel_futures=True)
    elif delayed_update:
        # one-deep software pipeline: iteration n dispatches utterance
        # u_n's forward (against params one update stale) and only then
        # drains u_{n-1}: fetch its posteriors, host FB, update. The
        # device forward of u_n runs during that host work.
        it = iter(reads)
        pend = None
        while True:
            tr = time.time()
            nxt = next(it, None)
            t_read += time.time() - tr
            cur = None
            if nxt is not None:
                e, feats_ext, T, labs, segs, lat = nxt
                tf = time.time()
                feats, _ = pipe.transform_block([feats_ext])
                cur = (e, T, labs, segs, lat, feats, forward_logpost(feats))
                t_fwd += time.time() - tf
            if pend is not None:
                e0, T0, labs0, segs0, lat0, feats0, dev0 = pend
                tf = time.time()
                log_post = to_host(dev0, T0)
                t_fwd += time.time() - tf
                consume(e0, T0, labs0, segs0, lat0, log_post, feats0)
            pend = cur
            if cur is None:
                break
    else:
        # sequential SGD semantics (TMpeCu.cc:461-672): utterance i+1's
        # forward must see utterance i's update, so forwards cannot run
        # ahead; the prefetch pipeline hides the I/O instead
        for item in reads:
            tr = time.time()
            e, feats_ext, T, labs, segs, lat = item
            t_read += time.time() - tr
            tf = time.time()
            feats, _ = pipe.transform_block([feats_ext])
            log_post = to_host(forward_logpost(feats), T)
            t_fwd += time.time() - tf
            consume(e, T, labs, segs, lat, log_post, feats)

    if p_targetmmf and not crossval:
        net.write(p_targetmmf)

    dt = time.time() - t0
    fps = frames / max(dt, 1e-9)
    print(f"\n===== TMpe FINISHED ( {dt:.1f}s ) "
          f"[FPS:{fps:.1f},RT:{fps / 100.0:.4f}] =====")
    print(f"Avg MPE accuracy: {acc_sum / max(n_utts, 1):.6g} "
          f"utts: {n_utts} T-decode: {t_decode:.2f}s")
    print(f"T-read: {t_read:.2f}s T-fwd: {t_fwd:.2f}s "
          f"T-decode: {t_decode:.2f}s T-update: {t_update:.2f}s")
    return 0


def _cli():
    """Reference-style top-level error handling (TNet.cc:371-376)."""
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except Exception as e:
        print("Exception thrown", file=sys.stderr)
        print(e, file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    _cli()
