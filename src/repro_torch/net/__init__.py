"""Backbone data plane (§2.3, §3.1): simulated dedicated network + RPC fleet.

Copies of the JAX package's ``repro.net`` modules that the paid write/read
path runs on, with the simulated clock's float arithmetic kept op for op:

* ``events``    — the shared deterministic event engine.
* ``backbone``  — datacenter topology, per-link latency/bandwidth and
  per-node NIC FIFO transfer accounting on a simulated clock.
* ``scheduler`` — deadline-based hedged chunk scheduler.
* ``fleet``     — multi-RPC router with pluggable policies.
* ``workloads`` — deterministic scenario generators plus the open-loop /
  closed-loop replay drivers.
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
from repro_torch.net.workloads import (
    ReadRequest,
    ReplayResult,
    RequestRecord,
    analytics_scan,
    replay_closed_loop,
    replay_open_loop,
    training_epoch,
    video_streaming,
    zipf_hotset,
)

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
    "ReadRequest",
    "RequestRecord",
    "ReplayResult",
    "replay_open_loop",
    "replay_closed_loop",
    "video_streaming",
    "training_epoch",
    "analytics_scan",
    "zipf_hotset",
]
