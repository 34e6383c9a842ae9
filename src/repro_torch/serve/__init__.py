"""Serving package of the port: the continuous-batching scheduler (host
state, shared text with the JAX package) over a torch paged-KV backend,
and the static engine (``serve.engine``)."""
from repro_torch.serve.backend import PagedKVBackend, SingleDeviceBackend
from repro_torch.serve.scheduler import (Completion, ContinuousBatchingEngine,
                                         Request, SchedulerConfig)

__all__ = ["PagedKVBackend", "SingleDeviceBackend",
           "Completion", "ContinuousBatchingEngine", "Request",
           "SchedulerConfig"]
