"""Inference serving: sessions, batching, the HTTP fronts, the fleet.

The port of ``flexflow_tpu/serving``: ``InferenceSession`` pads requests
to batch buckets and runs the compiled forward (or ``generate``);
``BatchScheduler`` batches requests under deadlines, admission control,
a per-model circuit breaker, batch-poison isolation and graceful drain;
``serve_http`` (threaded) and ``serve_async`` (asyncio) expose a
``ModelRepository`` over the Triton-style ``POST
/v2/models/<name>/infer`` JSON API. The fleet (continuous batching, the
multi-replica router, the autoscaler) is imported from
``flexflow_tpu_torch.serving.fleet``.
"""
from .session import InferenceSession, ModelRepository
from .scheduler import (BatchScheduler, CircuitBreaker, CircuitOpenError,
                        DeadlineExceededError, DeadlineRejectedError,
                        DrainingError, InvalidInputError, QueueFullError,
                        RequestRejected, SchedulerMetrics)
from .http_server import serve_http
from .async_server import serve_async

__all__ = ["InferenceSession", "ModelRepository", "BatchScheduler",
           "CircuitBreaker", "CircuitOpenError", "DeadlineExceededError",
           "DeadlineRejectedError", "DrainingError", "InvalidInputError",
           "QueueFullError", "RequestRejected", "SchedulerMetrics",
           "serve_http", "serve_async"]
