"""Host-side I/O: HTK features, MLF label files, SCP lists, MMF model text.

The port's copies of ``nnet_asr_tpu/io/*.py``; import the submodules.
"""
