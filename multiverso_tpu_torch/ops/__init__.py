"""Kernels of the PyTorch port and the live ops/introspection plane.

- **Kernel ops**: CUDA C++ under ``csrc/``, built on first use by
  ``_build.py``, and their plain PyTorch versions.  The attention
  function itself is ``ops.flash_attention.flash_attention``; word2vec's
  SGNS loss and gradients are ``ops.sgns.sgns_grads``.
- **Operations**: copies of the JAX package's host plane
  (docs/observability.md).  :class:`OpsClient` scrapes a rank's in-band
  ``/metrics``, health and table stats over the anonymous serve wire,
  :mod:`flight_recorder` keeps the bounded black-box ring that dumps
  ``blackbox_rank<r>.json`` on failure triggers, and :mod:`audit` diffs
  the delivery-audit books fleet-wide.  The scrape's server end is the
  port's copy of the native runtime (``native/``).
"""

from . import flash_attention, sgns
from .audit import audit_rows, checksum_divergence, diff_fleet
from .flash_attention import launch_counts, reset_launch_counts
from .flight_recorder import FlightRecorder, recorder
from .introspect import OpsClient, parse_prometheus

__all__ = ["flash_attention", "sgns", "launch_counts", "reset_launch_counts",
           "OpsClient", "parse_prometheus", "FlightRecorder", "recorder",
           "diff_fleet", "audit_rows", "checksum_divergence"]
