"""Host-side statistics the volume server reports."""

from .metrics import serving_stats  # noqa: F401
