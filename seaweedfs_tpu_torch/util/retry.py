"""Bounded retry with exponential backoff and full jitter.

``retry_call(fn, policy=..., classify=...)`` runs ``fn`` until it returns, a
classifier calls the error permanent (``POISON``), the attempts run out or
the deadline passes; then it raises :class:`RetryError`. The degraded EC
read's remote shard fetch (storage/store.py) is its caller here.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Optional

TRANSIENT = "transient"
POISON = "poison"


@dataclass(frozen=True)
class RetryPolicy:
    """``attempts`` counts calls, not sleeps: attempts=3 means at most three
    tries separated by at most two sleeps. ``deadline_s`` bounds the whole
    affair in wall time; whichever limit lands first wins."""

    attempts: int = 3
    base_s: float = 0.05
    cap_s: float = 2.0
    deadline_s: float = 30.0
    jitter: bool = True

    def delay(self, attempt: int) -> float:
        """Sleep before try ``attempt+1`` (attempt is 0-based)."""
        d = min(self.cap_s, self.base_s * (2 ** attempt))
        if self.jitter:
            d = random.uniform(0, d)  # full jitter
        return d


class RetryError(Exception):
    """Attempts or deadline exhausted (``permanent`` is False), or the
    classifier called the error poison (True). ``last`` is the final error."""

    def __init__(self, last: BaseException, attempts: int, permanent: bool = False):
        super().__init__(
            f"{'permanent' if permanent else 'exhausted'} after "
            f"{attempts} attempt(s): {last}"
        )
        self.last = last
        self.attempts = attempts
        self.permanent = permanent


def retry_call(
    fn: Callable,
    *args,
    policy: RetryPolicy,
    classify: Callable[[BaseException], str],
    on_retry: Optional[Callable[[BaseException, int, float], None]] = None,
    **kwargs,
):
    """Call ``fn(*args, **kwargs)`` with bounded retry; ``classify`` names
    each error ``TRANSIENT`` (try again) or ``POISON`` (give up now)."""
    deadline = time.monotonic() + policy.deadline_s
    attempts = max(1, policy.attempts)
    last: Optional[BaseException] = None
    attempt = 0
    for attempt in range(attempts):
        try:
            return fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — the classifier decides
            last = e
            if classify(e) == POISON:
                raise RetryError(e, attempt + 1, permanent=True) from e
            if attempt + 1 >= attempts:
                break
            d = policy.delay(attempt)
            if time.monotonic() + d > deadline:
                break
            if on_retry is not None:
                on_retry(e, attempt + 1, d)
            time.sleep(d)
    raise RetryError(last, min(attempt + 1, attempts)) from last
