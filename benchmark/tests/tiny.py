"""A tiny stand-in for each configuration and mix, for the CPU tests: the
same network shape and recipe at small widths, the same kinds of traffic
at small sizes; and the manifest with the streamed cell that PERF.md keeps
for later (``STREAM``), so that its path stays tested."""

import copy

from benchmark import harness


def configs() -> dict:
    man = harness.manifest()
    out = {}
    for entry in man["configs"]:
        cfg = copy.deepcopy(harness.load_config(entry))
        cfg.update(dims=[32, 64, 64, 128], bunch=32,
                   front_end={"bands": 8, "frame_ext": 3, "dct_bases": 4})
        out[entry["name"]] = cfg
    return out


MIXES = {"resident": {"kind": "resident", "stacks": 2, "stack_bunches": 8, "trace_seconds": 0.2},
         "stream": {"kind": "stream", "utterances": 60, "min_frames": 20, "max_frames": 40,
                    "segment_frames": [3, 12], "norm_utterances": 10, "cache_frames": 256,
                    "batch_utterances": 4, "reader_threads": 2, "trace_seconds": 0.2}}


STREAM = {"name": "prod_tnetcu.stream", "config": "prod_tnetcu", "traffic": "stream",
          "chips": 1, "why": "the streamed intake"}


def manifest() -> dict:
    man = copy.deepcopy(harness.manifest())
    man["workloads"].append(STREAM)
    man["per_layer"].append({"name": "intake_wait_share", "unit": "%", "better": "lower",
                             "source": "host_clock", "layer": "intake", "moves": "train_fps",
                             "workloads": [STREAM["name"]]})
    for m in man["per_layer"]:
        m["workloads"] = sorted(set(m["workloads"]) | {STREAM["name"]})
    return man


CELLS = [c["name"] for c in manifest()["workloads"]]


def run(workload: str, traced: bool = False, seed: int = 2 ** 31 + 77, seconds: float = 0.3):
    import time

    return harness.run_cell(manifest(), workload, seed, seconds, traced, "cpu",
                            time.perf_counter(), configs=configs(), mixes=MIXES)
