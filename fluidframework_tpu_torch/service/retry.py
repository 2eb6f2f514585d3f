"""RetryPolicy: bounded, deterministic, jittered exponential backoff.

The faultline engine (``testing/faults.py``) immediately exposes what the
stack was missing: nothing ever retried.  An ``RpcError`` killed the
caller; a transient durable-append failure unwound the whole submit.
This module is the one retry primitive every site uses — the
``FL-RACE-WAITFOREVER`` discipline applied to retry loops:

- **bounded**: ``max_attempts`` AND a total backoff ``budget`` (seconds
  of the injected clock); exhausting either surfaces the typed
  :class:`~..protocol.messages.RetryBudgetExhaustedError`, never a silent
  infinite loop;
- **deterministic**: backoff delays come from the *injected* clock/rng —
  a replay harness passes a ``VirtualClock`` (whose ``sleep`` advances
  virtual time) and a seeded ``random.Random``, making every retry
  schedule a pure function of its inputs; live hosts get wall-clock
  defaults and decorrelated jitter by passing their own rng;
- **nack-aware**: a :class:`NackError` hold waits ``max(backoff,
  retry_after)`` — the service's own pacing is never undercut;
- **fence-aware**: :class:`ShardFencedError` is only retryable when the
  caller supplies ``on_fence`` (re-resolve through the router); a plain
  retry against a fenced orderer can never succeed and re-raises
  immediately.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, Tuple

from ..protocol.messages import (NackError, RetryBudgetExhaustedError,
                                 ShardFencedError)
from ..utils.telemetry import LockedCounterSet

#: transient failures worth a blind resend: the transport/durability
#: layer hiccupped and the SAME bytes may land next time.  (NackError is
#: a ConnectionError subclass and is handled specially — its hold is the
#: server's, not the policy's; ShardFencedError likewise.)
DEFAULT_RETRY_ON: Tuple[type, ...] = (ConnectionError, OSError,
                                      TimeoutError)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Deterministic jittered exponential backoff with a hard budget.

    Delay for attempt ``n`` (1-based, after the n-th failure):
    ``min(max_delay, base_delay * multiplier**(n-1)) * (1 - jitter * u)``
    with ``u`` drawn from the caller's rng — jitter only ever *shortens*
    a delay, so ``budget`` math stays a safe upper bound.
    """

    max_attempts: int = 5
    base_delay: float = 0.05
    multiplier: float = 2.0
    max_delay: float = 5.0
    jitter: float = 0.5
    budget: float = 30.0

    def delay_for(self, attempt: int, rng: random.Random) -> float:
        raw = min(self.max_delay,
                  self.base_delay * self.multiplier ** (attempt - 1))
        return raw * (1.0 - self.jitter * rng.random())

    def run(
        self,
        fn: Callable[[], object],
        *,
        operation: str = "operation",
        sleep: Optional[Callable[[float], None]] = None,
        rng: Optional[random.Random] = None,
        retry_on: Tuple[type, ...] = DEFAULT_RETRY_ON,
        no_retry: Tuple[type, ...] = (),
        on_fence: Optional[Callable[[], None]] = None,
        counters: Optional[LockedCounterSet] = None,
    ) -> object:
        """Run ``fn`` under this policy.

        ``sleep`` is the backoff actuator (``time.sleep`` by default; a
        ``VirtualClock.sleep`` in replay harnesses).  ``no_retry`` takes
        precedence over ``retry_on`` (e.g. retry RpcError but never its
        EpochMismatchError subclass).  ``on_fence`` makes
        ShardFencedError retryable by re-resolving before the next
        attempt.  ``counters`` (when given) receives ``retry.attempts``,
        ``retry.retries``, ``retry.fence_resolves``,
        ``retry.nack_holds``, ``retry.exhausted`` bumps — the
        bench/oracle surface.
        """
        do_sleep = sleep if sleep is not None else time.sleep
        dice = rng if rng is not None else random.Random(0)
        slept = 0.0
        last: Optional[BaseException] = None
        for attempt in range(1, self.max_attempts + 1):
            if counters is not None:
                counters.bump("retry.attempts")
            try:
                return fn()
            except no_retry:
                # Checked FIRST: a site that declares e.g. NackError or
                # EpochMismatchError non-retryable keeps its own layer's
                # handling (the DeltaManager owns nack holds; epoch
                # mismatches need a reload, not a resend).
                raise
            except ShardFencedError as exc:
                if on_fence is None:
                    raise
                last = exc
                if counters is not None:
                    counters.bump("retry.fence_resolves")
                on_fence()
                delay = 0.0  # re-resolve IS the recovery; no backoff
            except NackError as exc:
                last = exc
                # The server's own pacing (retry_after) is never
                # undercut — with the adaptive admission it is
                # load-derived, not a constant, so the hold is the
                # overload signal worth counting.
                if counters is not None:
                    counters.bump("retry.nack_holds")
                delay = max(self.delay_for(attempt, dice),
                            float(exc.retry_after))
            except retry_on as exc:
                last = exc
                delay = self.delay_for(attempt, dice)
            if attempt == self.max_attempts or slept + delay > self.budget:
                break
            if counters is not None:
                counters.bump("retry.retries")
            if delay > 0.0:
                do_sleep(delay)
                slept += delay
        if counters is not None:
            counters.bump("retry.exhausted")
        raise RetryBudgetExhaustedError(operation, attempt, slept, last) \
            from last
