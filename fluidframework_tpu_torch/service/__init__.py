"""The ordering-service slice the catch-up seam needs (copies of the JAX
package's modules):

- :mod:`oplog`    — durable per-document op log;
- :mod:`scribe`   — summary validation + ack/nack;
- :mod:`orderer`  — per-document sequencing, the multi-document front door;
- :mod:`catchup`  — the bulk catch-up service that routes every kernel
  family through the port's replay entry points on the card;
- :mod:`catchup_cache` — its cache tiers 1 (results, single-flight) and
  0 (digest-gated delta download).

The broadcaster, retry policy, sharding and streaming fold are not ported
yet (ROADMAP queue 1 item 5).
"""

from .oplog import OpLog
from .orderer import DocumentOrderer, LocalOrderingService
from .scribe import Scribe

__all__ = ["OpLog", "DocumentOrderer", "LocalOrderingService", "Scribe"]
