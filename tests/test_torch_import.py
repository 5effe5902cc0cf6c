"""The port's import boundary and device resolution.

``nnet_asr_torch`` must load on a machine without JAX (the one with the
card has none) and must not import ``triton`` or build a kernel at import.
"""

import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

from nnet_asr_torch.device import gpuselect_device, resolve_device

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "nnet_asr_torch")

MODULES = [
    "nnet_asr_torch",
    "nnet_asr_torch.device",
    "nnet_asr_torch.models",
    "nnet_asr_torch.ops.objectives",
    "nnet_asr_torch.ops.fold_affine",
    "nnet_asr_torch.ops.kernels._build",
    "nnet_asr_torch.ops.kernels.matmul_act",
    "nnet_asr_torch.ops.kernels.softmax_ce",
    "nnet_asr_torch.ops.kernels.sgd_fused",
    "nnet_asr_torch.train.pipeline",
    "nnet_asr_torch.train.cache",
    "nnet_asr_torch.train.sgd",
    "nnet_asr_torch.train.trainer",
    "nnet_asr_torch.train.rbm",
    "nnet_asr_torch.train.rbm_scheduler",
    "nnet_asr_torch.train.recurrent",
    "nnet_asr_torch.tools.tnet",
    "nnet_asr_torch.tools.scheduler",
    "nnet_asr_torch.tools.tfeacat",
    "nnet_asr_torch.tools.tnorm",
    "nnet_asr_torch.tools.trbm",
    "nnet_asr_torch.tools.trecurrent",
    "nnet_asr_torch.tools.synth_corpus",
    "nnet_asr_torch.tools.gen_mlp_init",
    "nnet_asr_torch.tools.generators",
    "nnet_asr_torch.tools.gemm_ceiling",
    "nnet_asr_torch.ops.kernels.tile_plan",
    "nnet_asr_torch.ops.kernels.softmax_plan",
    "nnet_asr_torch.io",
    "nnet_asr_torch.io.htk",
    "nnet_asr_torch.io.mmf",
    "nnet_asr_torch.io.scp",
    "nnet_asr_torch.io.labels",
    "nnet_asr_torch.io.mlf",
    "nnet_asr_torch.io.native",
    "nnet_asr_torch.utils.config",
    "nnet_asr_torch.utils.prefetch",
    "nnet_asr_torch.utils.profiler",
    "nnet_asr_torch.utils.rand48",
    "nnet_asr_torch.train.newbob",
    "nnet_asr_torch.io.htk_hmm",
    "nnet_asr_torch.io.slf",
    "nnet_asr_torch.io.dictionary",
    "nnet_asr_torch.ops.mpe_device",
    "nnet_asr_torch.train.mpe",
    "nnet_asr_torch.train.mpe_native",
    "nnet_asr_torch.train.lattice_expand",
    "nnet_asr_torch.tools.tmpe",
    "nnet_asr_torch.tools.gen_gmmbypass",
    "nnet_asr_torch.train.resident",
    "nnet_asr_torch.io.wav",
    "nnet_asr_torch.ops.mfcc",
    "nnet_asr_torch.tools.thcopy",
    "nnet_asr_torch.tools.tjoiner",
    "nnet_asr_torch.tools.tsegmenter",
    "nnet_asr_torch.tools.sresults",
    "nnet_asr_torch.tools.gen_phone_loop",
    "nnet_asr_torch.tools.tnet2snet",
]


def test_port_imports_without_jax_triton_or_the_jax_package():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "from nnet_asr_torch.ops.kernels import _build\n"
            "assert _build._lib is None, 'kernel library loaded at import'\n"
            "bad = sorted(m for m in ('jax', 'jaxlib', 'triton', 'nnet_asr_tpu')\n"
            "             if m in sys.modules)\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _imported_modules(path):
    """(line, module) of every import statement in a Python file."""
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def test_no_source_imports_the_jax_package():
    """No module of the port, and not chip_smoke.py, imports nnet_asr_tpu
    (or jax), even lazily inside a function: the port keeps its own copies."""
    files = sorted(glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True))
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 30
    bad = [f"{os.path.relpath(f, ROOT)}:{line} imports {mod}"
           for f in files for line, mod in _imported_modules(f)
           if mod.split(".")[0] in ("nnet_asr_tpu", "jax", "jaxlib")]
    assert not bad, bad


def test_library_path_is_keyed_by_source_hash():
    from nnet_asr_torch.ops.kernels import _build
    path = _build.library_path()
    assert path.startswith(_build.BUILD_DIR)
    assert path == _build.library_path()
    assert len(_build._sources()) >= 2
    assert all(s.endswith(".cu") for s in _build._sources())


def test_resolve_device_cpu_only_by_name():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        assert resolve_device(None) == torch.device("cuda", 0)
        assert gpuselect_device(-1) == torch.device("cuda", 0)
    else:
        for spec in (None, "cuda", "cuda:0", 0):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                resolve_device(spec)
        with pytest.raises(RuntimeError):
            gpuselect_device(-1)
