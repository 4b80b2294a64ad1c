"""Process-wide telemetry. Only the metrics registry is ported so far; it
carries the ``ssz.digests`` counter."""

from . import metrics  # noqa: F401

__all__ = ["metrics"]
