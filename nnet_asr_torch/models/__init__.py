"""Model components and networks as ``nn.Module``s."""

from .components import (
    Component, BiasedLinearity, DiscreteLinearity, SharedLinearity, SparseLinearity,
    ClusterLinearity, Rbm, RbmSparse, Recurrent, Sigmoid, Softmax, BlockSoftmax,
    Expand, Copy, Transpose, BlockLinearity, Bias, Window, Log, BlockArray,
    TAG_TO_TYPE,
)
from .network import Network, read_components, write_component
