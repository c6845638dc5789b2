"""Serving front doors: capacity bucketing + the point-cloud session, and
the LM's slot engine."""
from .bucketing import BucketedPlanner, bucket_capacity, bucket_packed
from .engine import Request, ServeEngine
from .session import (HealthReport, SpiraSession, TuneReport,
                      compile_network)
