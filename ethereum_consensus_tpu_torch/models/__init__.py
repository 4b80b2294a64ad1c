"""Per-fork spec modules: phase0, altair, bellatrix, capella and deneb
(slot, block and epoch processing, the upgrades between them), with the
columnar epoch engine (``epoch_vector``), its registry columns, the
altair-family block-scoped attestation fast path and the withdrawals
columns (``ops_vector``) and the committee masks (``committees``)."""

from . import altair, bellatrix, capella, deneb, phase0  # noqa: F401
