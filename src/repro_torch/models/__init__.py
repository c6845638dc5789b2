"""Point-cloud networks on the Spira engine, and the LM substrate
(``common``, ``layers``, ``moe``, ``mamba``, ``xlstm``, ``transformer``)."""
from .common import ModelConfig, SuperBlock, dense_lm, moe_lm
from . import common, layers, mamba, moe, pointcloud, transformer, xlstm
