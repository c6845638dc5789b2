"""Serving front door: capacity bucketing + the session."""
from .bucketing import bucket_capacity, bucket_packed
from .session import HealthReport, SpiraSession, compile_network
