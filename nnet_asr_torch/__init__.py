"""nnet_asr_torch — the PyTorch + CUDA port of nnet_asr_tpu for one NVIDIA H100.

The JAX package ``nnet_asr_tpu`` stays the reference. This package mirrors
its layout so each module's counterpart is easy to find:

  models/    components as ``nn.Module``s + the ``Network`` stack
  ops/       objectives, transform folding, and ``ops/kernels/``: the
             hand-written CUDA kernels (sources in ``csrc/``) with their
             plain PyTorch versions
  train/     transform pipeline, device frame cache, SGD, trainer
  tools/     CLI entry points with the reference option vocabulary
  io/        HTK features, MLF, SCP, labels, MMF text, the native reader
  utils/     option parsing, Rand48, profiler, prefetch

The host code it shares with the JAX package is copied, never imported:
``io/{htk,mmf,scp,labels,mlf,native,htk_hmm,slf,dictionary}.py``,
``native/{htkio,mpefb}.cc``, ``utils/{config,prefetch,rand48}.py``,
``train/{newbob,rbm_scheduler,mpe,mpe_native,lattice_expand}.py``,
``tools/{gen_mlp_init,generators,gen_gmmbypass}.py`` are copies at the
original's relative path; ``utils/profiler.py`` keeps the original's
phases and report and adds spans timed on the card. This package imports
``torch`` and nothing of ``jax`` or ``nnet_asr_tpu``.
"""

__version__ = "0.1.0"
