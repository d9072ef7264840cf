"""heat_tpu_torch.serve — multi-tenant micro-batched inference serving.

Port of the in-process serving core of ``heat_tpu.serve``; four parts,
one pipeline:

- :mod:`registry` — versioned per-tenant estimator store over the
  checkpoint manifests (``<root>/<tenant>/<model>/v<N>.h5``), LRU-cached
  so one estimator object backs every request for a version;
- :mod:`batcher` — async micro-batching: concurrent submits coalesce
  into fixed-shape batches, rows bucketed to powers of two with
  canonical zero padding + validity mask;
- :mod:`engine` — persistent fused predict programs (``htt.fuse`` keyed
  on the bucketed shapes, one CUDA-graph replay each on the card):
  exactly one dispatch per micro-batch, ``guard("degrade")`` quarantine
  for poisoned payloads, ``serve:*`` spans and queue/occupancy gauges;
- :mod:`loadgen` — seeded open-loop load generation producing the
  ``serve_predictions_per_sec`` / ``serve_p99_ms`` headlines with an
  in-run unbatched direct-predict twin as the bitwise golden;
- :mod:`fleet` — fleet-scale elasticity on top of the engine: watermark
  autoscaling over the queue/SLO signals, zero-cold-start replicas
  installing AOT bundles from the registry sidecar, and seeded canary
  rollout with a same-run stable golden twin;
- :mod:`procfleet` / :mod:`ingress` / :mod:`wfq` / :mod:`health` — the
  multi-process serving plane: replica OS processes (warm-started from
  the sidecar, zero-compile asserted in each hello frame, placed on the
  parent's device) behind a loopback length-prefixed RPC, per-tenant
  weighted-fair admission, sticky sessions, a circuit breaker per
  replica, kill -9 re-queue with a deterministic fleet reply ledger, the
  asyncio ingress with its hedged client, and an aggregated per-replica
  Prometheus endpoint.

The contract underneath it all: a batched reply is BITWISE equal to the
same request's unbatched predict, because every predict program in the
library is row-independent and the pad rows are sliced away before the
reply leaves the engine.
"""

from .batcher import MicroBatcher, Request, StagingPool, bucket_rows, pad_batch
from .engine import Reply, ServeEngine
from .errors import (
    IngressBootError,
    ServeClosedError,
    ServeDeadlineError,
    ServeOverloadError,
)
from .fleet import CanaryConfig, FleetEngine, WatermarkAutoscaler
from .ingress import FleetMetricsServer, HedgePolicy, Ingress, IngressClient
from .procfleet import ProcFleet, ReplicaProc
from .registry import (
    ManifestError,
    ModelNotFoundError,
    ModelRegistry,
    RegistryError,
    VersionNotFoundError,
)
from .wfq import TenantPolicy, WeightedFairQueue
from . import loadgen

__all__ = [
    "CanaryConfig",
    "FleetEngine",
    "FleetMetricsServer",
    "HedgePolicy",
    "Ingress",
    "IngressBootError",
    "IngressClient",
    "ManifestError",
    "MicroBatcher",
    "ModelNotFoundError",
    "ModelRegistry",
    "ProcFleet",
    "RegistryError",
    "Reply",
    "ReplicaProc",
    "Request",
    "ServeClosedError",
    "ServeDeadlineError",
    "ServeEngine",
    "ServeOverloadError",
    "StagingPool",
    "TenantPolicy",
    "VersionNotFoundError",
    "WatermarkAutoscaler",
    "WeightedFairQueue",
    "bucket_rows",
    "loadgen",
    "pad_batch",
]
