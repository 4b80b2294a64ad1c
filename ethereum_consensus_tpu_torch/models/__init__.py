"""Per-fork spec modules: phase0 and altair (slot, block and epoch
processing, the phase0 → altair upgrade), with the columnar epoch engine
(``epoch_vector``), its registry columns and the altair block-scoped
attestation fast path (``ops_vector``) and the committee masks
(``committees``)."""

from . import altair, phase0  # noqa: F401
