"""Backbone data plane (§2.3, §3.1): simulated dedicated network + RPC fleet.

Copies of the JAX package's ``repro.net`` modules that the paid write/read
path runs on, with the simulated clock's float arithmetic kept op for op:

* ``events``    — the shared deterministic event engine.
* ``backbone``  — datacenter topology, per-link latency/bandwidth and
  per-node NIC FIFO transfer accounting on a simulated clock.
* ``scheduler`` — deadline-based hedged chunk scheduler.
* ``fleet``     — multi-RPC router with pluggable policies.
"""
from repro_torch.net.backbone import Backbone, LinkSpec, NICSpec
from repro_torch.net.events import (
    Acquire,
    Channel,
    EventLoop,
    Join,
    Recv,
    Release,
    Sleep,
    Transfer,
)
from repro_torch.net.fleet import (
    CacheAffinityPolicy,
    LatencyAwarePolicy,
    PowerOfTwoPolicy,
    RPCFleet,
)
from repro_torch.net.scheduler import FetchResult, HedgedScheduler

__all__ = [
    "Backbone",
    "LinkSpec",
    "NICSpec",
    "EventLoop",
    "Channel",
    "Sleep",
    "Transfer",
    "Acquire",
    "Release",
    "Join",
    "Recv",
    "HedgedScheduler",
    "FetchResult",
    "RPCFleet",
    "LatencyAwarePolicy",
    "CacheAffinityPolicy",
    "PowerOfTwoPolicy",
]
