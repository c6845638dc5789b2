"""Point-cloud networks on the Spira engine, and the dense LM substrate
(``common``, ``layers``, ``transformer``)."""
from . import common, layers, pointcloud, transformer
