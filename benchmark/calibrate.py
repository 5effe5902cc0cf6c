"""The readings the limits of the checks are set from, on the card at a
cell's own size, several seeds in one process:

    python3 benchmark/calibrate.py --workload <name> --seeds 11,12,13 [--out FILE]

For each seed: the program's first steps (set-up exactly as a run makes
them) against the f32 reference (the lower readings), and, each put in the
program's place against the same reference, the controls (the reference
with TF32 products: emulated, ``tf32``, and the card's own, ``tf32_hw``)
and the planted faults (``half``: half of the bunch left out, the mean
taken over the rest; ``frozen``: the state returned unchanged). Prints one
JSON line a seed, then for each number the largest sound reading and the
smallest of each control and fault.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SIDES = (("control_tf32", "tf32", None), ("control_tf32_hw", "tf32_hw", None),
         ("fault_half", "f32", "half"), ("fault_frozen", "f32", "frozen"))


def seed_readings(cfg: dict, mix: dict, seed: int, device) -> dict:
    """{side: {number: value}} of one seed."""
    import torch

    from benchmark import check, harness

    run = harness.Cell(cfg, mix, seed, device)
    run.close()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    want = harness.reference_readings(cfg, mix, seed, device, run.norm)
    out = {"program": check.compare(run.readings.readings(), want),
           "program_by_leaf": check.by_leaf(run.readings.readings(), want)}
    for side, precision, fault in SIDES:
        got = harness.reference_readings(cfg, mix, seed, device, run.norm, precision, fault)
        out[side] = check.compare(got, want)
        if side.startswith("control"):
            out[f"{side}_by_leaf"] = check.by_leaf(got, want)
    want64 = harness.reference_readings(cfg, mix, seed, device, run.norm, "f64")
    out["f64"] = {"program": check.compare(run.readings.readings(), want64),
                  "reference_f32": check.compare(want, want64),
                  "control_tf32_hw": check.compare(harness.reference_readings(
                      cfg, mix, seed, device, run.norm, "tf32_hw"), want64)}
    return out


def summary(rows: list) -> dict:
    from benchmark import check

    names = list(rows[0]["program"])
    out = {"program_max": {k: max(r["program"][k] for r in rows) for k in names}}
    for side, _, _ in SIDES:
        out[f"{side}_min"] = {k: min(r[side][k] for r in rows) for k in names}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    import torch

    from benchmark import harness, traffic
    from benchmark.reference.mlp_frame_ce import no_tf32

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    no_tf32()
    man = harness.manifest()
    cell, entry = harness.find(man, args.workload)
    cfg, mix = harness.load_config(entry), traffic.load(cell["traffic"])
    device = torch.device("cuda", 0)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = seed_readings(cfg, mix, seed, device)
        r.update(workload=args.workload, seed=seed, seconds=time.perf_counter() - t0)
        rows.append(r)
        print(json.dumps(r), flush=True)
    s = dict(summary(rows), workload=args.workload, seeds=len(rows),
             card=torch.cuda.get_device_name(0))
    print(json.dumps(s), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in rows + [s]:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
