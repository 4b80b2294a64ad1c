"""Per-fork spec modules. Only phase0 is ported so far: slot, block and
epoch processing, with the columnar epoch engine (``epoch_vector``), its
registry columns (``ops_vector``) and the committee masks
(``committees``)."""

from . import phase0  # noqa: F401
