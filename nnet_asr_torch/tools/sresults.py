"""SResults — transcription scoring (HResults/SResults equivalent).

Levenshtein-aligns hypothesis MLF records against a reference MLF and
prints the HTK-style report:

    SENT: %Correct=.. [H=.., S=.., N=..]
    WORD: %Corr=.., Acc=.. [H=.., D=.., S=.., I=.., N=..]

HTK scoring costs (sub=10, del=ins=7) so H/D/S/I counts match
HResults/SResults on the same inputs.

The port's copy of ``nnet_asr_tpu/tools/sresults.py``, behaviour unchanged.
"""

from __future__ import annotations

import argparse
import sys

from ..io.mlf import MlfReader


def _words(lines):
    out = []
    for line in lines:
        parts = line.split()
        if not parts:
            continue
        if len(parts) >= 3 and parts[0].lstrip("-").isdigit():
            out.append(parts[2])
        elif len(parts) >= 1 and not parts[0].lstrip("-").isdigit():
            out.append(parts[0])
    return out


def align_counts(ref, hyp):
    """(H, D, S, I) with HTK costs: sub 10, del 7, ins 7."""
    n, m = len(ref), len(hyp)
    INF = 1 << 30
    # dp over (n+1)x(m+1); track op counts via backpointers
    cost = [[0] * (m + 1) for _ in range(n + 1)]
    back = [[0] * (m + 1) for _ in range(n + 1)]   # 0 diag, 1 del, 2 ins
    for i in range(1, n + 1):
        cost[i][0] = cost[i - 1][0] + 7
        back[i][0] = 1
    for j in range(1, m + 1):
        cost[0][j] = cost[0][j - 1] + 7
        back[0][j] = 2
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            d = cost[i - 1][j - 1] + (0 if ref[i - 1] == hyp[j - 1] else 10)
            del_ = cost[i - 1][j] + 7
            ins = cost[i][j - 1] + 7
            best = min(d, del_, ins)
            cost[i][j] = best
            back[i][j] = 0 if best == d else (1 if best == del_ else 2)
    H = D = S = I = 0
    i, j = n, m
    while i > 0 or j > 0:
        b = back[i][j]
        if b == 0 and i > 0 and j > 0:
            if ref[i - 1] == hyp[j - 1]:
                H += 1
            else:
                S += 1
            i -= 1
            j -= 1
        elif b == 1 and i > 0:
            D += 1
            i -= 1
        else:
            I += 1
            j -= 1
    return H, D, S, I


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sresults")
    ap.add_argument("-I", "--ref", required=True, help="reference MLF")
    ap.add_argument("labels", nargs="?", help="label list (unused, HTK compat)")
    ap.add_argument("hyp", help="hypothesis MLF")
    args = ap.parse_args(argv)

    ref_mlf = MlfReader(args.ref)
    hyp_mlf = MlfReader(args.hyp)

    tH = tD = tS = tI = 0
    sent_h = sent_n = 0
    for name in hyp_mlf.names():
        base = name.rsplit(".", 1)[0]
        ref_name = base + ".lab"
        if ref_name not in ref_mlf:
            print(f"WARNING: no reference for {name}", file=sys.stderr)
            continue
        ref = _words(ref_mlf.read_block(ref_name))
        hyp = _words(hyp_mlf.read_block(name))
        H, D, S, I = align_counts(ref, hyp)
        tH += H; tD += D; tS += S; tI += I
        sent_n += 1
        if D == 0 and S == 0 and I == 0:
            sent_h += 1

    N = tH + tD + tS
    corr = 100.0 * tH / max(N, 1)
    acc = 100.0 * (tH - tI) / max(N, 1)
    print("------------------------ Overall Results --------------------------")
    print(f"SENT: %Correct={100.0 * sent_h / max(sent_n, 1):.2f} "
          f"[H={sent_h}, S={sent_n - sent_h}, N={sent_n}]")
    print(f"WORD: %Corr={corr:.2f}, Acc={acc:.2f} "
          f"[H={tH}, D={tD}, S={tS}, I={tI}, N={N}]")
    return 0


def _cli():
    """Reference-style top-level error handling (TNet.cc:371-376)."""
    import sys
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
