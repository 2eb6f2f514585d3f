"""Single-serialization broadcast fan-out for the ordering tier (the
Redis-pub/sub Broadcaster capability of SURVEY §2.3, collapsed into the
process).

The TCP front door used to register one closure pair per (session,
document): every sequenced message was re-encoded once per subscriber —
N clients on a hot document cost N ``json.dumps`` of the same payload on
the sequencing hot path.  This module subscribes ONCE per document
channel, encodes each :class:`SequencedMessage` exactly once through
``protocol/wire.py``, and hands the identical frame bytes to every
subscribed sink (the counter-pinned serialize-once contract: M clients ×
K ops → exactly K encodes).

Backpressure: a sink accepts a frame or reports saturation
(``write_frame`` → False).  A saturated sink is **demoted** — removed
from the channel, told once via ``on_demoted`` — instead of stalling the
shard or buffering unboundedly: the client backfills from the durable
op log (its delta storage) and re-subscribes.  One laggard can never
hold back the other subscribers of its document.

Sink protocol (duck-typed; ``service/server.py``'s ``_ClientSession`` is
the production implementation):

- ``write_frame(data: bytes) -> bool`` — enqueue one encoded frame;
  False = would exceed the sink's buffer budget (demote me).
- ``write_signal(data: bytes, signal: dict) -> bool`` — same, for signal
  frames; the sink applies its per-client target filter (targeted
  signals must not reach other clients) and returns True for frames it
  filters out.
- ``on_demoted(doc_id: str, head_seq: int) -> None`` — called once,
  after removal, outside the broadcaster lock.
- ``on_fence(doc_id: str, epoch: str, head_seq: int) -> None`` — shard
  failover notification (see :meth:`refence`).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from ..protocol.messages import SequencedMessage
from ..protocol.wire import (WIRE_VERSION, encode_sequenced_message,
                             frame_bytes)
from ..utils.telemetry import CounterSet


class _Channel:
    """One (document, wire name) broadcast channel: a single endpoint
    subscription fanning encoded frames to every sink."""

    def __init__(self, doc_id: str, out_doc: str, endpoint) -> None:
        self.doc_id = doc_id
        self.out_doc = out_doc
        self.endpoint = endpoint
        self.sinks: List[object] = []  # guarded-by: Broadcaster._lock
        # Bound per-channel callbacks: subscribe/unsubscribe need stable
        # function identity across refence().
        self.on_op = None
        self.on_signal = None

    def wire(self, broadcaster: "Broadcaster") -> None:
        self.on_op = lambda msg: broadcaster._publish_op(self, msg)
        self.on_signal = lambda signal: broadcaster._publish_signal(
            self, signal)
        self.endpoint.subscribe(self.on_op)
        self.endpoint.subscribe_signals(self.on_signal)

    def unwire(self) -> None:
        self.endpoint.unsubscribe(self.on_op)
        self.endpoint.unsubscribe_signals(self.on_signal)


class Broadcaster:
    """Per-document fan-out with exactly-once serialization, laggard
    demotion, and failover re-attach.

    Counters (all under the one lock): ``encodes`` (op messages encoded —
    the serialize-once pin), ``writes`` (frames accepted by sinks),
    ``demotions`` (laggards removed), ``signal_encodes``, ``fences``
    (channels re-attached across a shard failover).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._channels: Dict[Tuple[str, str], _Channel] = {}  # guarded-by: _lock
        self.counters = CounterSet(
            "encodes", "writes", "demotions", "signal_encodes", "fences",
        )  # guarded-by: _lock

    # -- subscription management -----------------------------------------------

    def attach(self, doc_id: str, endpoint, sink,
               out_doc: Optional[str] = None) -> None:
        """Subscribe ``sink`` to ``doc_id``'s broadcast under the wire
        name ``out_doc`` (tenant-visible id; defaults to ``doc_id``).
        The first sink of a channel wires the single endpoint
        subscription; later sinks share it."""
        key = (doc_id, out_doc if out_doc is not None else doc_id)
        # Wire/unwire transitions happen UNDER the lock: an attach racing
        # a detach/demote/refence must never leave an orphaned-but-wired
        # channel (encoding forever for nobody) or a doubly-wired one
        # (every op delivered twice).  The subscription calls are plain
        # list operations on the sequencer — nothing blocking rides the
        # critical section.
        with self._lock:
            channel = self._channels.get(key)
            if channel is None:
                channel = _Channel(key[0], key[1], endpoint)
                self._channels[key] = channel
                channel.wire(self)
            if sink not in channel.sinks:
                channel.sinks.append(sink)

    def detach(self, doc_id: str, sink,
               out_doc: Optional[str] = None) -> None:
        key = (doc_id, out_doc if out_doc is not None else doc_id)
        with self._lock:
            channel = self._channels.get(key)
            if channel is None or sink not in channel.sinks:
                return
            channel.sinks.remove(sink)
            if not channel.sinks:
                del self._channels[key]
                channel.unwire()

    def detach_all(self, sink) -> None:
        """Remove a sink from every channel (session teardown)."""
        with self._lock:
            for key in [k for k, ch in self._channels.items()
                        if sink in ch.sinks]:
                channel = self._channels[key]
                channel.sinks.remove(sink)
                if not channel.sinks:
                    del self._channels[key]
                    channel.unwire()

    def docs_with_channels(self) -> List[str]:
        """Internal doc ids that currently have live broadcast channels
        — the set a shard-fence handler must re-attach (everything else
        recovers lazily on next touch)."""
        with self._lock:
            return sorted({d for d, _o in self._channels})

    def subscriber_count(self, doc_id: str,
                         out_doc: Optional[str] = None) -> int:
        key = (doc_id, out_doc if out_doc is not None else doc_id)
        with self._lock:
            channel = self._channels.get(key)
            return len(channel.sinks) if channel is not None else 0

    # -- publish (called from the sequencer broadcast chain) -------------------

    def _publish_op(self, channel: _Channel, msg: SequencedMessage) -> None:
        # ONE encode regardless of subscriber count — the whole point.
        frame = frame_bytes({
            "v": WIRE_VERSION, "event": "op", "doc": channel.out_doc,
            "msg": encode_sequenced_message(msg),
        })
        with self._lock:
            self.counters.bump("encodes")
            sinks = list(channel.sinks)
        laggards = []
        accepted = 0
        for sink in sinks:
            if sink.write_frame(frame):
                accepted += 1
            else:
                laggards.append(sink)
        with self._lock:
            self.counters.bump("writes", accepted)
        for sink in laggards:
            self._demote(channel, sink, msg.seq)

    def _publish_signal(self, channel: _Channel, signal: dict) -> None:
        frame = frame_bytes({
            "v": WIRE_VERSION, "event": "signal", "doc": channel.out_doc,
            "signal": signal,
        })
        with self._lock:
            self.counters.bump("signal_encodes")
            sinks = list(channel.sinks)
        laggards = []
        for sink in sinks:
            if not sink.write_signal(frame, signal):
                laggards.append(sink)
        # Saturated on a signal = saturated, same demotion (signals are
        # lossy-by-contract, but a full buffer means the op stream behind
        # it is stalled too).
        for sink in laggards:
            self._demote(channel, sink, -1)

    def _demote(self, channel: _Channel, sink, head_seq: int) -> None:
        """Remove a saturated sink from ONE channel and notify it once.
        Other channels the sink subscribes to are untouched (it may be
        current on them); an empty channel unwires its subscription."""
        with self._lock:
            if sink not in channel.sinks:
                return  # already demoted/detached by a racing publisher
            channel.sinks.remove(sink)
            self.counters.bump("demotions")
            if not channel.sinks:
                # Only drop the channel if this object is still the live
                # registration (a racing detach+attach may have replaced
                # it); unwire under the lock either way.
                if self._channels.get(
                        (channel.doc_id, channel.out_doc)) is channel:
                    del self._channels[(channel.doc_id, channel.out_doc)]
                channel.unwire()
        sink.on_demoted(channel.out_doc, head_seq)

    # -- failover --------------------------------------------------------------

    def refence(self, doc_id: str, endpoint, epoch: str) -> int:
        """Shard failover for ``doc_id``: move every channel of the
        document onto the recovered owner's ``endpoint`` and tell each
        sink the storage generation changed (clients unpin and drop
        pre-fence caches instead of waiting to trip over epochMismatch).
        Returns the number of sinks notified."""
        to_notify: List[Tuple[_Channel, List[object]]] = []
        with self._lock:
            moved = [ch for (d, _o), ch in self._channels.items()
                     if d == doc_id]
            if moved:
                self.counters.bump("fences")
            for channel in moved:
                # The old endpoint's orderer is fenced — unsubscribing
                # from it is a plain list removal and always safe; the
                # whole swap stays under the lock so a racing attach can
                # neither double-wire nor observe a half-moved channel.
                channel.unwire()
                channel.endpoint = endpoint
                channel.wire(self)
                to_notify.append((channel, list(channel.sinks)))
        notified = 0
        head = endpoint.head_seq if to_notify else 0
        for channel, sinks in to_notify:
            for sink in sinks:
                sink.on_fence(channel.out_doc, epoch, head)
                notified += 1
        return notified

    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = self.counters.snapshot()
            out["channels"] = len(self._channels)
            out["subscriptions"] = sum(
                len(ch.sinks) for ch in self._channels.values()
            )
        return out
