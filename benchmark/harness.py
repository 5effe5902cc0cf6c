"""One run of one cell: set-up, the first steps and their readings, the
measured window, the traced window, the metrics and the check against the
plain reference.

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration in the file the manifest names, its traffic mix in
``traffic/<mix>.json``, every metric's reader in ``metrics/<name>.py``,
the reference in ``reference/<config's reference>.py`` and the limits of
the checks in ``limits/<cell>.json``. A later cell, mix or metric is a new
file and a new entry; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from types import ModuleType, SimpleNamespace
from typing import Dict, List, Optional

import torch

from . import check, trace, traffic, work
from .reference import stream_intake
from .reference.mlp_frame_ce import no_tf32

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def find(man: dict, workload: str):
    """(cell entry, configuration entry) of ``workload``."""
    cells = {c["name"]: c for c in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    return cell, next(c for c in man["configs"] if c["name"] == cell["config"])


def load_config(entry: dict) -> dict:
    with open(os.path.join(ROOT, entry["file"])) as f:
        return json.load(f)


def metric_module(name: str) -> ModuleType:
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(man: dict, workload: str, traced: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end ones, or
    with ``traced`` its per-layer ones. A metric with ``workloads`` is
    reported in those cells; an end-to-end one without, in every cell; a
    per-layer one without, in every cell that reports its ``moves``."""
    e2e = [m for m in man["end_to_end"] if workload in m.get("workloads", [workload])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if workload in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in moved)]


def reference_readings(cfg: dict, mix: dict, seed: int, device, norm=None,
                       precision: str = "f32", fault: Optional[str] = None) -> dict:
    """The reference's readings of the first ``check.STEPS`` steps, from
    the weights and bunches the benchmark makes from the seed."""
    ref = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    rec = check.Recorder(cfg)
    if mix["kind"] == "resident":
        feats, labels = traffic.resident_stack(cfg, mix, seed, 0, device)
        bunches = [(feats[k], labels[k]) for k in range(check.STEPS)]
        del feats, labels
    else:
        bunches = stream_intake.first_bunches(cfg, mix, seed, norm, check.STEPS, device)
    ref.run(cfg, traffic.weights(cfg, seed, device), bunches, rec.after_step, precision, fault)
    return rec.readings()


class Cell:
    """One cell's program, set up from the seed (the corpus written under
    a temporary directory for a streamed mix)."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device):
        from .program import Program

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.corpus_dir, self.norm, corpus = None, None, None
        self.phases = {}
        t = time.perf_counter()
        if mix["kind"] == "stream":
            self.corpus_dir = tempfile.mkdtemp(prefix="bench_corpus_")
            corpus = traffic.write_corpus(cfg, mix, seed, self.corpus_dir, device)
            self.norm = (corpus["bias"], corpus["window"])
            t = self._phase("corpus", t)
        self.program = Program(cfg, mix, seed, device, corpus)
        t = self._phase("program", t)
        self.readings = check.Recorder(cfg)
        self.program.first_steps(self.readings.after_step, check.STEPS)
        self._phase("first_steps", t)

    def _phase(self, name: str, t: float) -> float:
        now = time.perf_counter()
        self.phases[name] = now - t
        return now

    def close(self) -> None:
        if self.program is not None:
            self.program.close()
            self.program = None
        if self.corpus_dir is not None:
            shutil.rmtree(self.corpus_dir, ignore_errors=True)
            self.corpus_dir = None


def run_cell(man: dict, workload: str, seed: int, seconds: float, traced: bool,
             device, t_start: float, configs: Optional[Dict[str, dict]] = None,
             mixes: Optional[Dict[str, dict]] = None,
             limits: Optional[Dict[str, float]] = None) -> dict:
    """One run; the result line as a dict, ``checks`` last. ``configs``,
    ``mixes`` and ``limits`` stand in for the files (the CPU tests)."""
    no_tf32()
    device = torch.device(device)
    cell, entry = find(man, workload)
    cfg = (configs or {}).get(entry["name"]) or load_config(entry)
    mix = (mixes or {}).get(cell["traffic"]) or traffic.load(cell["traffic"])
    limits = limits or check.load_limits(workload)
    before = time.perf_counter() - t_start
    run = Cell(cfg, mix, seed, device)
    try:
        setup_s = time.perf_counter() - t_start
        print("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                    [("start", before)] + list(run.phases.items())),
              file=sys.stderr, flush=True)
        window = run.program.window(seconds)
        tr, sub = None, None
        if traced:
            box = {}

            def traced_run(phase):
                box["window"] = run.program.window(mix["trace_seconds"], phase)

            tr = trace.record(traced_run, torch)
            sub = box["window"]
        peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
    finally:
        run.close()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    values = check.compare(run.readings.readings(),
                           reference_readings(cfg, mix, seed, device, run.norm))
    ok, rows = check.verdict(values, limits)
    ctx = SimpleNamespace(cfg=cfg, mix=mix, setup_s=setup_s, window=window, trace=tr,
                          traced=sub, work=work)
    metrics = {}
    for m in cell_metrics(man, workload, traced):
        v = metric_module(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": bool(ok and window["failed"] == 0), "attempted": window["bunches"],
           "failed": window["failed"], "metrics": metrics, "device": dev}
    if tr is not None:
        busy, _ = tr.busy()
        dev["busy_s"], dev["window_s"] = busy, tr.window_s
        out["breakdown"] = trace.breakdown(tr)
    out["checks"] = rows
    return out
