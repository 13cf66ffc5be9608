"""Metrics the session records its stage walls into."""

from .metrics import Gauge, Histogram, Registry

__all__ = ["Gauge", "Histogram", "Registry"]
