"""repro_torch.fleet: replicated serving, health-checked engine replicas
behind a failover router (port of ``repro/fleet``; pure host Python, so
the router and the health machine are ``repro``'s line for line).

The paper's hardware half scales through hierarchical control — one
top-level controller steering many identical PE blocks.  At serving scale
the analogue is a fleet of ``ContinuousEngine`` replicas behind a
``Router``: join-shortest-queue placement over healthy replicas, hedged
requests for tail latency, and — the hard part — crash failover that
migrates every lost in-flight request to a survivor via recompute-prefill
(the same teacher-forcing mechanism local preemption uses), so greedy
outputs stay token-identical to the B=1 oracle across a replica death.

``EngineReplica`` is the RPC-shaped seam: everything the router needs is
behind submit/step/cancel/result/salvage/drain/stats, so a remote stub
can replace it without touching router logic.

On the card the replicas of one process share the weights (one
``params`` module, baked once: ``precompute_serving_params`` is
idempotent, so a second replica keeps the plane addresses the first one's
CUDA graph captured) and each holds its own pool and captured decode step.
A DOWN replica's pool and graph are abandoned, not freed.
"""
from .replica import (DEGRADED, DOWN, HEALTHY, EngineReplica, LostRequest,
                      Salvage)
from .router import Router

__all__ = ["EngineReplica", "Router", "LostRequest", "Salvage",
           "HEALTHY", "DEGRADED", "DOWN"]
