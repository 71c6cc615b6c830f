"""Bounded retry with exponential backoff and full jitter.

``retry_call(fn, policy=..., classify=...)`` runs ``fn`` until it returns, a
classifier calls the error permanent (``POISON``), the attempts run out or
the deadline passes; then it raises :class:`RetryError`. Its callers here:
the degraded EC read's remote shard fetch (storage/store.py), the shell's
re-run of a read-only command after a master failover (shell/shell.py), and
filer.sync's per-event apply (replication/filer_sync.py), whose outer loop
paces itself by ``backoff_delays``.
"""

from __future__ import annotations

import random
import time
import urllib.error
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

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


#: replication apply path: a dead target cluster is normal (datacenter
#: loss), so keep individual applies snappy and let the outer loop pace
REPLICATION_POLICY = RetryPolicy(attempts=3, base_s=0.05, cap_s=1.0,
                                 deadline_s=15.0)

#: interactive/read paths (the shell's read-only commands)
READ_POLICY = RetryPolicy(attempts=3, base_s=0.05, cap_s=0.5, deadline_s=10.0)


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


def classify_error(exc: BaseException) -> str:
    """Default classifier: 429 and 5xx statuses and the connection-level
    OSError family are transient; other 4xx statuses and everything else
    are poison."""
    status = getattr(exc, "status", None)
    if status is None and isinstance(exc, urllib.error.HTTPError):
        status = exc.code
    if status is not None:
        if status == 429 or status >= 500:
            return TRANSIENT
        if 400 <= status < 500:
            return POISON
    if isinstance(exc, (urllib.error.URLError, OSError)):
        return TRANSIENT
    return POISON


def backoff_delays(policy: RetryPolicy) -> Iterator[float]:
    """The sleep schedule between attempts: yields ``attempts - 1`` delays
    (a generator per burst; make a fresh one to reset after success)."""
    for attempt in range(max(0, policy.attempts - 1)):
        yield policy.delay(attempt)


def retry_call(
    fn: Callable,
    *args,
    policy: RetryPolicy,
    classify: Callable[[BaseException], str] = classify_error,
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
