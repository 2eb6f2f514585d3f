"""Canonical wire error-code registry: code <-> exception <-> retryability.

Every error code that crosses a process boundary — frame responses from
``service/server.py`` and ``service/frontdoor.py``, nack bodies, and the
per-doc ``submit_mixed`` outcome channel — is declared here in ONE
top-level dict literal, so the FL-ERR fluidlint family can statically
cross-check both directions: a ``"code"`` literal produced anywhere in the
package must be a registered row, and a registered row must be produced
(and, for the frame channel, handled driver-side) somewhere.  Mirror of
``service/gates.py``: the registry imports nothing from the serving tier,
so it can never participate in an import cycle, and call sites keep their
literals — the AST rules need the strings visible; the registry pins each
one to a declared contract instead of replacing it with a constant.

Retryability classes (the SEMANTICS.md "Error taxonomy & retryability"
contract — what each class promises the host):

``transport``
    The request may never have reached the server.  Resending the SAME
    bytes after backoff is correct; the sequencer's client_seq dedup makes
    it safe even for submits.
``nack-paced``
    Deliberate server pushback.  Wait the server's ``retry_after`` (not
    the client's backoff curve), then resend; ``RetryPolicy`` implements
    the pacing natively.
``reconnect``
    An in-place resend can NEVER succeed: the caller must reconnect,
    re-resolve ownership, or rebase first.  These must ride ``no_retry``
    (or ``on_fence`` for the fence family) at every retry site — blind
    resends burn the budget against a dead contract (a resent
    ``ConnectionLostError`` did exactly that).
``fatal``
    Deterministic rejection (auth failure, unknown method, a server-side
    exception).  Retrying is never correct.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

TRANSPORT = "transport"
NACK_PACED = "nack-paced"
RECONNECT = "reconnect"
FATAL = "fatal"

RETRY_CLASSES = (TRANSPORT, NACK_PACED, RECONNECT, FATAL)

#: wire channels a code can ride —
#:   ``frame``   — ``{"ok": false, "code": X, ...}`` responses; the
#:                 driver's code-dispatch chain raises the declared
#:                 exception type.
#:   ``nack``    — ``{"ok": false, "nack": {"code": X, ...}}``; decoded
#:                 uniformly into ``NackError`` (the code rides
#:                 ``NackError.code``), so per-code driver branches are
#:                 optional.
#:   ``outcome`` — per-doc ``submit_mixed`` outcome dicts; ``exception``
#:                 names the SERVER-side class the code classifies, and
#:                 drivers decode the whole channel uniformly into
#:                 ``ConnectionError`` text (``procclient._decode_outcome``).
CHANNELS = ("frame", "nack", "outcome")

#: The registry.  Keys are the exact strings that cross the wire; the
#: FL-ERR-CODE rule pins every produced/handled literal in the package to
#: a row here, both directions.
WIRE_ERRORS: Dict[str, Dict[str, str]] = {
    # frame channel ----------------------------------------------------------
    "epochMismatch": {"channel": "frame",
                      "exception": "EpochMismatchError",
                      "retry": "reconnect"},
    "shardFenced": {"channel": "frame",
                    "exception": "ShardFencedError",
                    "retry": "reconnect"},
    "wrongShard": {"channel": "frame",
                   "exception": "DocRelocatedError",
                   "retry": "reconnect"},
    "connectionLost": {"channel": "frame",
                       "exception": "ConnectionLostError",
                       "retry": "reconnect"},
    "internal": {"channel": "frame",
                 "exception": "RpcError",
                 "retry": "fatal"},
    # nack channel -----------------------------------------------------------
    "throttled": {"channel": "nack",
                  "exception": "NackError",
                  "retry": "nack-paced"},
    "staleView": {"channel": "nack",
                  "exception": "NackError",
                  "retry": "reconnect"},
    "overloaded": {"channel": "nack",
                   "exception": "NackError",
                   "retry": "nack-paced"},
    "shuttingDown": {"channel": "nack",
                     "exception": "NackError",
                     "retry": "nack-paced"},
    # outcome channel --------------------------------------------------------
    "fenced": {"channel": "outcome",
               "exception": "ShardFencedError",
               "retry": "reconnect"},
    "unknownDoc": {"channel": "outcome",
                   "exception": "KeyError",
                   "retry": "fatal"},
    "fault": {"channel": "outcome",
              "exception": "Exception",
              "retry": "fatal"},
    "shardDead": {"channel": "outcome",
                  "exception": "ConnectionError",
                  "retry": "reconnect"},
}

#: The typed-exception surface of the protocol/driver tiers and the
#: retryability class each one declares.  ``parent`` is the nearest
#: REGISTERED ancestor (builtin bases like ConnectionError/OSError are
#: deliberately outside the table — ``RetryPolicy`` names them in its
#: default ``retry_on`` and handles Nack/Fence natively).  FL-ERR-RETRY
#: walks these chains: a reconnect- or fatal-class exception whose chain
#: is named in a site's ``retry_on`` must appear in that site's
#: ``no_retry`` (or ride ``on_fence`` for the fence family).
EXCEPTIONS: Dict[str, Dict[str, Optional[str]]] = {
    "RpcError": {"parent": None, "retry": "fatal"},
    "RpcTransportError": {"parent": "RpcError", "retry": "transport"},
    "RpcTimeoutError": {"parent": "RpcError", "retry": "transport"},
    "ConnectionLostError": {"parent": "RpcTransportError",
                            "retry": "reconnect"},
    "EpochMismatchError": {"parent": "RpcError", "retry": "reconnect"},
    "UnknownWireCodeError": {"parent": "RpcError", "retry": "fatal"},
    "NackError": {"parent": None, "retry": "nack-paced"},
    "ShardFencedError": {"parent": None, "retry": "reconnect"},
    "DocRelocatedError": {"parent": "ShardFencedError",
                          "retry": "reconnect"},
    "RetryBudgetExhaustedError": {"parent": None, "retry": "fatal"},
}


def spec(code: str) -> Dict[str, str]:
    """Declared row for a wire code.  KeyError on an unregistered code —
    a producer must register before shipping (FL-ERR-CODE enforces the
    static mirror of this)."""
    return WIRE_ERRORS[code]


def is_registered(code: object) -> bool:
    return isinstance(code, str) and code in WIRE_ERRORS


def codes(channel: Optional[str] = None) -> Tuple[str, ...]:
    """Registered codes, optionally restricted to one wire channel."""
    if channel is None:
        return tuple(WIRE_ERRORS)
    return tuple(c for c, row in WIRE_ERRORS.items()
                 if row["channel"] == channel)


def retry_class(code: str) -> str:
    return WIRE_ERRORS[code]["retry"]


def exception_spec(name: str) -> Dict[str, Optional[str]]:
    """Declared row for a typed exception.  KeyError when unregistered."""
    return EXCEPTIONS[name]


def ancestors(name: str) -> Tuple[str, ...]:
    """Registered ancestor chain of an exception, nearest first."""
    out = []
    cur = EXCEPTIONS[name]["parent"]
    while cur is not None:
        if cur in out:
            raise ValueError(f"parent cycle through {cur!r}")
        out.append(cur)
        cur = EXCEPTIONS[cur]["parent"]
    return tuple(out)


def _validate() -> None:
    for code, row in WIRE_ERRORS.items():
        assert row["channel"] in CHANNELS, (code, row)
        assert row["retry"] in RETRY_CLASSES, (code, row)
        exc = row["exception"]
        # outcome rows classify with whatever the server raised, builtins
        # included; frame/nack rows must name a registered typed exception
        if row["channel"] != "outcome":
            assert exc in EXCEPTIONS, (code, exc)
    for name, row in EXCEPTIONS.items():
        assert row["retry"] in RETRY_CLASSES, (name, row)
        parent = row["parent"]
        assert parent is None or parent in EXCEPTIONS, (name, parent)
        ancestors(name)  # raises on a parent cycle


_validate()
