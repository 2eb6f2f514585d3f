"""Distributed ID compression: UUID-sized stable ids → small ints.

Capability-equivalent of the reference's ``id-compressor`` package
(SURVEY.md §2.1: session-space/op-space ids, local vs final ids, cluster
allocation; upstream paths UNVERIFIED — empty reference mount).

Model:
- Each session (client) mints **local ids**: negative ints -1, -2, … —
  usable immediately, no coordination.
- When the session's ops flush, the runtime attaches the session's new
  **creation range** to the batch; when the batch is *sequenced*, every
  client (including the author) **finalizes** the range identically:
  final ids are allocated from **clusters** — contiguous blocks of the
  positive final-id space reserved per session, so consecutive locals
  map to consecutive finals and lookup tables stay tiny.
- A compressed id decompresses to a stable string ``<session>:<gen>``
  that is identical on every client forever; recompress inverts it.

The cluster table is a plain dict fold over sequenced ranges — cheap,
deterministic, and serialized into summaries."""

from __future__ import annotations

import uuid
from typing import Dict, List, Optional, Tuple


class IdCompressor:
    """Per-session compressor with a shared, sequenced cluster table."""

    def __init__(self, session_id: Optional[str] = None,
                 cluster_capacity: int = 512) -> None:
        self.session_id = session_id or uuid.uuid4().hex
        self.cluster_capacity = cluster_capacity
        self._gen_count = 0          # locals minted by THIS session
        self._taken_through = 0      # locals already handed to a range
        # session -> list of [base_final, base_gen, capacity, used]
        self._clusters: Dict[str, List[list]] = {}
        self._next_final = 0
        # final id -> (session, gen) reverse lookup is derivable from the
        # cluster table; no separate map needed.

    # -- local allocation ------------------------------------------------------

    def generate(self) -> int:
        """Mint a new id in session space (negative local id)."""
        self._gen_count += 1
        return -self._gen_count

    def take_next_creation_range(self) -> Optional[dict]:
        """The unfinalized locals minted since the last take — attach to
        the next outbound batch.  None if nothing new."""
        if self._gen_count == self._taken_through:
            return None
        first = self._taken_through + 1
        count = self._gen_count - self._taken_through
        self._taken_through = self._gen_count
        return {"session": self.session_id, "firstGen": first,
                "count": count}

    def rollback_ranges(self, first_gen: int) -> None:
        """Un-take ranges from ``first_gen`` onward: their wire batches were
        discarded before reaching the sequencer (reconnect / rehydrate), so
        the next take re-attaches those locals — otherwise they would never
        finalize and their op-space forms could never resolve remotely."""
        self._taken_through = min(self._taken_through, first_gen - 1)

    # -- sequenced finalization (identical on every client) --------------------

    def finalize_range(self, range_: dict) -> None:
        session = range_["session"]
        first_gen, count = range_["firstGen"], range_["count"]
        clusters = self._clusters.setdefault(session, [])
        remaining = count
        gen = first_gen
        while remaining > 0:
            if clusters and self._cluster_free(clusters[-1]) > 0:
                cluster = clusters[-1]
            else:
                cluster = [self._next_final, gen,
                           max(self.cluster_capacity, remaining), 0]
                self._next_final += cluster[2]
                clusters.append(cluster)
            take = min(remaining, self._cluster_free(cluster))
            cluster[3] += take
            gen += take
            remaining -= take

    @staticmethod
    def _cluster_free(cluster: list) -> int:
        return cluster[2] - cluster[3]

    # -- space normalization ---------------------------------------------------

    def normalize_to_op_space(self, id_: int) -> int:
        """Session-space → op-space: a finalized local becomes its final id
        (what goes on the wire); an unfinalized local stays local."""
        if id_ >= 0:
            return id_
        final = self._final_of(self.session_id, -id_)
        return final if final is not None else id_

    def normalize_to_session_space(self, id_: int, origin: str) -> int:
        """Op-space id from ``origin`` → this session's view: our own
        finals become locals (negative); others' stay final."""
        if id_ < 0:
            if origin != self.session_id:
                raise ValueError(
                    f"local id {id_} from foreign session {origin!r}"
                )
            return id_
        located = self._locate_final(id_)
        if located is not None and located[0] == self.session_id:
            return -located[1]
        return id_

    # -- stable (de)compression ------------------------------------------------

    def decompress(self, id_: int) -> str:
        if id_ < 0:
            return f"{self.session_id}:{-id_}"
        located = self._locate_final(id_)
        if located is None:
            raise KeyError(f"final id {id_} is not allocated")
        return f"{located[0]}:{located[1]}"

    def recompress(self, stable: str) -> int:
        session, gen_s = stable.rsplit(":", 1)
        gen = int(gen_s)
        if session == self.session_id:
            final = self._final_of(session, gen)
            return -gen if final is None else final
        final = self._final_of(session, gen)
        if final is None:
            raise KeyError(f"stable id {stable!r} is not finalized")
        return final

    # -- internals -------------------------------------------------------------

    def _final_of(self, session: str, gen: int) -> Optional[int]:
        for base_final, base_gen, _cap, used in \
                self._clusters.get(session, []):
            if base_gen <= gen < base_gen + used:
                return base_final + (gen - base_gen)
        return None

    def _locate_final(self, final: int) -> Optional[Tuple[str, int]]:
        for session, clusters in self._clusters.items():
            for base_final, base_gen, _cap, used in clusters:
                if base_final <= final < base_final + used:
                    return session, base_gen + (final - base_final)
        return None

    # -- persistence -----------------------------------------------------------

    def serialize(self) -> dict:
        """Shared (sequenced) state only — local counters are per-session
        and die with the session, exactly like the reference's serialized
        compressor without local state."""
        return {
            "clusters": {s: [list(c) for c in cs]
                         for s, cs in sorted(self._clusters.items())},
            "nextFinal": self._next_final,
            "capacity": self.cluster_capacity,
        }

    @staticmethod
    def deserialize(state: dict,
                    session_id: Optional[str] = None) -> "IdCompressor":
        comp = IdCompressor(session_id=session_id,
                            cluster_capacity=state["capacity"])
        comp._clusters = {s: [list(c) for c in cs]
                          for s, cs in state["clusters"].items()}
        comp._next_final = state["nextFinal"]
        return comp
