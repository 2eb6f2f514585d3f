"""The ordering-service slice (copies of the JAX package's modules, with
the catch-up fold on the card):

- :mod:`oplog`    — durable per-document op log;
- :mod:`scribe`   — summary validation + ack/nack;
- :mod:`orderer`  — per-document sequencing, the multi-document front door;
- :mod:`catchup`  — the bulk catch-up service that routes every kernel
  family through the port's replay entry points on the card;
- :mod:`catchup_cache` — its cache tiers 1 (results, single-flight) and
  0 (digest-gated delta download), and the streaming fold's
  published-summary index;
- :mod:`streamfold` — the sequencer-attached streaming fold (commit-driven
  incremental summaries, summary-anchored op-log truncation);
- :mod:`sharding` — document-partitioned orderer shards on the host
  (rendezvous routing, epoch-fenced failover) behind the same surface;
- :mod:`broadcaster` — serialize-once broadcast fan-out with laggard
  demotion;
- :mod:`retry`    — the client-side retry policy;
- :mod:`server`   — the TCP ordering server (``python -m
  fluidframework_tpu_torch.service.server``), whose ``catchup`` RPC and
  streaming fold run on the server's device;
- :mod:`shardhost` — one shard as a standalone server process (``python
  -m fluidframework_tpu_torch.service.shardhost --device ...``: own
  durable log, shared summary store, migration/adoption control plane,
  SIGTERM drain-and-seal, its catch-ups on its device);
- :mod:`frontdoor` — the routing front door over shard processes
  (supervision, heartbeats, SIGKILL-fenced failover, live migration),
  on the :mod:`framepump` event loop.  Imported lazily — not re-exported
  here — so the in-proc service surface keeps its import graph;
- :mod:`procclient` — the swarm-facing service adapter over the front
  door.
"""

from .broadcaster import Broadcaster
from .oplog import OpLog
from .orderer import DocumentOrderer, LocalOrderingService
from .retry import RetryPolicy
from .scribe import Scribe
from .sharding import ShardedOrderingService, ShardRouter

__all__ = [
    "Broadcaster", "OpLog", "DocumentOrderer", "LocalOrderingService",
    "RetryPolicy", "Scribe", "ShardRouter", "ShardedOrderingService",
]
