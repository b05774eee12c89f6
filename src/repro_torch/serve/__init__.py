"""``repro_torch.serve`` — async shape-bucketed request batching over the
plan cache (the serving runtime).

Concurrent transform requests coalesce into padded shape-buckets and
execute as ONE batched cached plan per bucket — the batch dimension is
a free leading dim on every registered backend, so a server at high
concurrency multiplies per-image throughput over per-request dispatch
without changing a coefficient:

    from repro_torch.serve import DwtServer, ServeConfig

    async with DwtServer(ServeConfig(max_batch=16)) as srv:
        pyr = await srv.submit(img, scheme="ns-polyconv", levels=3)

Batches run on the card unless ``ServeConfig(device="cpu")``.  Counters
surface in ``repro_torch.engine.stats()["serve"]``.
"""
from repro_torch.faults.policy import CircuitOpenError, DeadlineExceeded
from repro_torch.serve.bucket import (BucketKey, BucketSpec, Request,
                                      bucket_batches, padded_batch)
from repro_torch.serve.metrics import (METRICS, reset as reset_metrics,
                                       serve_stats)
from repro_torch.serve.scheduler import (DwtServer, QueueFullError,
                                         ServeConfig, WorkerDied, serve_map)

__all__ = [
    "DwtServer", "ServeConfig", "QueueFullError", "WorkerDied",
    "serve_map",
    "DeadlineExceeded", "CircuitOpenError",
    "BucketKey", "BucketSpec", "Request", "padded_batch", "bucket_batches",
    "METRICS", "serve_stats", "reset_metrics",
]
