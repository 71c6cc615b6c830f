"""The gateways' filer-client factory: the one-address branch of the JAX
package's ``filer/ring.py``.

There, one address gives a plain ``FilerClient`` and several a
``RingFilerClient`` over the consistent-hash ring of filers. The ring is
not ported yet, so a list of several addresses raises instead of quietly
taking the first.
"""

from __future__ import annotations

from .client import FilerClient


def make_client(filers: "str | list[str]", retry_reads: bool = True) -> FilerClient:
    """A ``FilerClient`` for one filer address (``"host:port"``, or a list
    of one). Accepts the comma-separated form the CLI flags use, and raises
    ``ValueError`` for more than one address."""
    if isinstance(filers, str):
        filers = [f.strip() for f in filers.split(",") if f.strip()]
    if len(filers) != 1:
        raise ValueError(
            f"{len(filers)} filer addresses given: the multi-filer ring "
            "(RingFilerClient) is not ported yet (ROADMAP Queue A item 1); "
            "give one filer")
    return FilerClient(filers[0], retry_reads=retry_reads)
