"""The class decorator of the JAX package's ``util/racecheck.py``.

There, ``instrument`` wraps a class's ``__setattr__`` with a lockset write
tracker under ``SWEED_RACE_CHECK=1`` and is the identity otherwise. The
tracker is not ported yet, so here ``instrument`` is always the identity:
a decorated class carries no wrapper whatever the environment says.
"""

from __future__ import annotations


def instrument(cls):
    """Class decorator: the identity (the write tracker is not ported)."""
    return cls


__all__ = ["instrument"]
