"""Serving front doors: capacity bucketing + the point-cloud session, its
request engine and overload policies, and the LM's slot engine."""
from .bucketing import BucketedPlanner, bucket_capacity, bucket_packed
from .engine import (PointCloudRequest, PointCloudServeEngine, Request,
                     ServeEngine)
from .session import (HealthReport, SpiraSession, TuneReport,
                      compile_network)
from .faults import (FakeClock, FaultySession, PoisonError, TransientError,
                     feature_poison, poison_coords, poison_features)
from .scheduler import (AdmissionConfig, AdmissionController, BreakerConfig,
                        BucketScheduler, CircuitBreaker, DegradationLadder,
                        DispatchTimeoutError, FifoScheduler, LadderConfig)
from .loadgen import LoadReport, arrival_times, make_traffic, run_open_loop
