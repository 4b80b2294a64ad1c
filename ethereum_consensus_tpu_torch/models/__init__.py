"""Per-fork spec modules: phase0, altair, bellatrix, capella, deneb and
electra (slot, block and epoch processing, the upgrades between them,
genesis from eth1 deposits over ``genesis_common``), with the
columnar epoch engine (``epoch_vector``), its registry columns, the
altair-family block-scoped attestation fast path and the withdrawals
columns (``ops_vector``) and the committee masks (``committees``)."""

from . import altair, bellatrix, capella, deneb, electra, phase0  # noqa: F401
