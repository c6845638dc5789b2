"""Point-cloud networks on the Spira engine, and the LM substrate
(``common``, ``layers``, ``moe``, ``mamba``, ``xlstm``, ``transformer``)."""
from . import common, layers, mamba, moe, pointcloud, transformer, xlstm
