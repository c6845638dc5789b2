"""Point-cloud networks on the Spira engine."""
from . import pointcloud
