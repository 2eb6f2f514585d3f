"""Mock runtimes: multi-client DDS testing with no server.

The reference's key test mechanism (SURVEY.md §4: MockContainerRuntimeFactory
+ MockFluidDataStoreRuntime): the factory holds submitted ops
un-sequenced; ``process_all_messages`` stamps them through the in-proc
Sequencer and delivers to every client replica in total order, so N
replicas of a DDS converge deterministically and tests can control
interleavings (deliver some messages, edit concurrently, deliver the
rest).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List

from ..dds.shared_object import SharedObject
from ..protocol.messages import MessageType, RawOperation, SequencedMessage
from ..protocol.sequencer import Sequencer


class _MockDeltaConnection:
    """The per-(client, channel) submit handle given to a DDS."""

    def __init__(self, runtime: "MockClientRuntime", channel_id: str) -> None:
        self._runtime = runtime
        self._channel_id = channel_id

    def submit(self, contents, ref_seq=None) -> int:
        return self._runtime.submit_channel_op(self._channel_id, contents,
                                               ref_seq)

    @property
    def ref_seq(self):
        return self._runtime.ref_seq

    @property
    def min_seq(self):
        return getattr(self._runtime, "min_seq", 0)


class MockClientRuntime:
    """One simulated client: routes channel ops out to the factory and
    inbound sequenced messages to its attached channel replicas."""

    def __init__(self, factory: "MockContainerRuntimeFactory", client_id: str):
        self.factory = factory
        self.client_id = client_id
        self.ref_seq = factory.sequencer.seq  # last processed seq
        self._client_seq = 0
        self.channels: Dict[str, SharedObject] = {}

    def attach(self, dds: SharedObject) -> SharedObject:
        self.channels[dds.id] = dds
        dds.connect(_MockDeltaConnection(self, dds.id), self.client_id)
        return dds

    def submit_channel_op(self, channel_id: str, contents,
                          ref_seq=None) -> int:
        self._client_seq += 1
        self.factory.enqueue(
            RawOperation(
                client_id=self.client_id,
                client_seq=self._client_seq,
                ref_seq=self.ref_seq if ref_seq is None else ref_seq,
                type=MessageType.OP,
                contents={"address": channel_id, "contents": contents},
            )
        )
        return self._client_seq

    def _advance_channels(self, msg: SequencedMessage, skip_address=None) -> None:
        """Every container message advances every channel's window (seq /
        min_seq for zamboni), whether or not the op was addressed to it."""
        for address, dds in self.channels.items():
            if address == skip_address:
                continue
            advance = getattr(dds, "advance", None)
            if advance:
                advance(msg.seq, msg.min_seq)

    def deliver(self, msg: SequencedMessage) -> None:
        self.ref_seq = msg.seq
        if msg.type is not MessageType.OP:
            self._advance_channels(msg)
            return
        envelope = msg.contents
        dds = self.channels.get(envelope["address"])
        if dds is None:
            self._advance_channels(msg)
            return
        dds.process(
            dataclasses.replace(msg, contents=envelope["contents"]),
            local=(msg.client_id == self.client_id),
        )
        self._advance_channels(msg, skip_address=envelope["address"])


class MockContainerRuntimeFactory:
    """Holds pending raw ops; sequencing happens on demand."""

    def __init__(self) -> None:
        self.sequencer = Sequencer()
        self.clients: List[MockClientRuntime] = []
        self._pending_raw: Deque[RawOperation] = collections.deque()
        self._delivery_queue: Deque[SequencedMessage] = collections.deque()
        self.sequencer.subscribe(self._delivery_queue.append)

    def create_client(self, client_id: str) -> MockClientRuntime:
        self.sequencer.connect(client_id)
        runtime = MockClientRuntime(self, client_id)
        self.clients.append(runtime)
        self._drain_delivery()  # deliver the JOIN immediately
        return runtime

    def enqueue(self, op: RawOperation) -> None:
        self._pending_raw.append(op)

    @property
    def pending_count(self) -> int:
        return len(self._pending_raw)

    def process_some_messages(self, count: int) -> None:
        for _ in range(count):
            if not self._pending_raw:
                break
            op = self._pending_raw.popleft()
            self.sequencer.submit(op)
            self._drain_delivery()

    def process_all_messages(self) -> None:
        self.process_some_messages(len(self._pending_raw))

    def advance_min_seq(self) -> None:
        """Report every client as fully caught-up, advancing the MSN to the
        head — lets tests force zamboni/window eviction."""
        for client in self.clients:
            self.sequencer.update_ref_seq(client.client_id, self.sequencer.seq)
        self.sequencer.tick()  # propagate the new MSN
        self._drain_delivery()

    def _drain_delivery(self) -> None:
        while self._delivery_queue:
            msg = self._delivery_queue.popleft()
            for client in self.clients:
                client.deliver(msg)


def channel_log(factory: MockContainerRuntimeFactory, address: str,
                min_seq_exclusive: int = 0) -> list:
    """Extract one channel's sequenced ops from the durable log, unwrapped
    from their envelopes — the exact stream a catch-up replay (CPU oracle or
    device kernel) folds over."""
    out = []
    for msg in factory.sequencer.log:
        if msg.type is not MessageType.OP or msg.seq <= min_seq_exclusive:
            continue
        envelope = msg.contents
        if envelope.get("address") != address:
            continue
        out.append(dataclasses.replace(msg, contents=envelope["contents"]))
    return out
