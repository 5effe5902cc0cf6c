"""Run one cell of the benchmark of ``nnet_asr_torch`` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It needs a CUDA card (as many as the cell
asks for); without one, or without the port beside it, it exits non-zero
and prints no result. It sets up the cell from the seed, trains for
``--seconds``, checks the first steps against the plain reference and
prints one JSON line: ``correct``, ``attempted``, ``failed``, ``metrics``
(with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones), ``device`` (with ``--trace 1`` also ``busy_s`` and
``window_s``, and a ``breakdown``), and last ``checks``, each number
compared beside its limit, which also end standard error. A run whose
process has loaded JAX or the JAX package by the end exits non-zero with
no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "nnet_asr_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cache_dirs() -> None:
    """Every compiler cache inside the checkout, at fixed paths: the port
    builds its kernels into ``build/kernels`` and its HTK library into
    ``build/native`` beside its package."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", "bench_cache", sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    # the checkout's root, not this folder, heads the path: the harness's
    # modules are imported as the package ``benchmark``
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    import torch

    from benchmark import harness

    man = harness.manifest()
    cell, _ = harness.find(man, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import nnet_asr_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the port nnet_asr_torch is not importable here: {e}",
              file=sys.stderr)
        return 3
    out = harness.run_cell(man, args.workload, args.seed, args.seconds, bool(args.trace),
                           "cuda:0", T_START)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}; no result", file=sys.stderr)
        return 4
    print(json.dumps(out), flush=True)
    for name, row in out["checks"].items():
        print(f"check {name}: {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
