"""Async serving pipeline: the control plane in front of the engine tiers.

``DecodeService.start_pipeline()`` attaches a :class:`PipelineBroker`
(worker threads overlapping ingest with decode, capability lanes, adaptive
microbatching, admission control, predictive hot-set speculation) and turns
the service into a thin façade — see the module docstrings here:

  * :mod:`.broker`     — request broker, worker threads, backpressure
  * :mod:`.controller` — EMA arrival/service estimators -> flush decisions
                         + deadline classes
  * :mod:`.capability` — per-client parallelism + downscaled plan/container
  * :mod:`.predictor`  — popularity-decayed heat + speculative pre-thinning

``controller`` and ``capability`` are the JAX package's modules, copied
(``capability`` reads a card stream's words through ``.cpu()``); the broker
and the predictor are forked: their waits are on the readiness events the
service records after each launch.
"""

from .broker import (BrokerSaturated, ContentQuarantined, PipelineBroker,
                     PipelineTicket, TicketCancelled)
from .capability import CapabilityRegistry, ClientCapability
from .controller import AdaptiveController, ControllerConfig, FlushDecision
from .predictor import HeatTracker, SpeculativePrethinner

__all__ = [
    "AdaptiveController",
    "BrokerSaturated",
    "CapabilityRegistry",
    "ContentQuarantined",
    "ClientCapability",
    "ControllerConfig",
    "FlushDecision",
    "HeatTracker",
    "PipelineBroker",
    "PipelineTicket",
    "SpeculativePrethinner",
    "TicketCancelled",
]
