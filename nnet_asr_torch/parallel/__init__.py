"""Multi-device training over torch.distributed (port of nnet_asr_tpu/parallel/):
the (data, model) mesh, the sharded step and trainer, and the data-parallel
CD-1 and MPE steps. One process per rank (``parallel/mesh.py``)."""

from .mesh import Mesh, make_mesh
from .sharded_step import ShardedTrainState, make_sharded_train_step
