"""Continuous-batching split-serving subsystem, on the card.

Port of ``repro/serve``: a fixed-slot continuous-batching runtime
(:mod:`repro_torch.serve.runtime`), its serializable knobs
(:mod:`repro_torch.serve.config`, hung off ``ExperimentConfig.serve``),
and a closed-loop load generator (:mod:`repro_torch.serve.loadgen`).
"""
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.loadgen import (make_prompts, percentiles,
                                       run_closed_loop)
from repro_torch.serve.runtime import (Request, ServeDispatchError,
                                       ServeRuntime, STATUS_DONE,
                                       STATUS_EVICTED_DEADLINE,
                                       STATUS_EVICTED_FAILURE, STATUS_QUEUED,
                                       STATUS_REJECTED, STATUS_RUNNING,
                                       TERMINAL)

__all__ = [
    "ServeConfig", "ServeRuntime", "Request", "ServeDispatchError",
    "run_closed_loop", "make_prompts", "percentiles",
    "STATUS_QUEUED", "STATUS_RUNNING", "STATUS_DONE", "STATUS_REJECTED",
    "STATUS_EVICTED_DEADLINE", "STATUS_EVICTED_FAILURE", "TERMINAL",
]
