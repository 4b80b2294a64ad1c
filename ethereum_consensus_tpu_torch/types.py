"""Fork-polymorphic chain types (the reference's generated src/types/ layer).

The port carries phase0 through electra: ``FORK_SEQUENCE`` is ``(phase0,
altair, bellatrix, capella, deneb, electra)``, and a container of no known
fork raises ``UnknownForkError``.

Reference parity: ethereum-consensus/src/types/ (13,272 LoC generated by
spec-gen's type_generator.rs): one wrapper per chain object spanning every
fork, with cross-fork field accessors (types/beacon_state.rs:331-420),
``version()``, and serde that tries forks newest→oldest
(type_generator.rs:760). Nine polymorphic kinds (type_generator.rs Type:22-32);
the port carries the two that block application needs, without the
newest-to-oldest codec (``wrap`` detects a container's fork from its
class).

Design: instead of 13k lines of generated match arms, one small wrapper
class per kind holding ``(fork, data)`` — field access delegates to the
underlying fork-specific container (`__getattr__`), so every accessor the
reference generates exists here by construction, including fields added by
later forks.
"""

from __future__ import annotations

from .error import UnknownForkError
from .fork import Fork
from .models import altair, bellatrix, capella, deneb, electra, phase0

__all__ = [
    "FORK_SEQUENCE",
    "FORK_MODULES",
    "fork_module",
    "BeaconState",
    "SignedBeaconBlock",
]

FORK_SEQUENCE = (
    Fork.PHASE0,
    Fork.ALTAIR,
    Fork.BELLATRIX,
    Fork.CAPELLA,
    Fork.DENEB,
    Fork.ELECTRA,
)

FORK_MODULES = {
    Fork.PHASE0: phase0,
    Fork.ALTAIR: altair,
    Fork.BELLATRIX: bellatrix,
    Fork.CAPELLA: capella,
    Fork.DENEB: deneb,
    Fork.ELECTRA: electra,
}


def fork_module(fork: Fork):
    try:
        return FORK_MODULES[fork]
    except KeyError:
        raise UnknownForkError(f"unknown fork {fork}") from None


class _Polymorphic:
    """Base for fork-spanning wrappers around per-fork SSZ containers."""

    KIND: str = ""  # container attribute name in each fork's build() ns
    FORKS: tuple = FORK_SEQUENCE  # forks where the kind exists

    # the fork tag lives in a private slot: ``.fork`` must keep delegating
    # to the underlying state's `fork` *field* (the Fork container), exactly
    # like the generated accessors; use ``version()`` for the tag
    __slots__ = ("_fork", "data")

    def __init__(self, fork: Fork, data):
        object.__setattr__(self, "_fork", Fork(fork))
        object.__setattr__(self, "data", data)

    # -- construction --------------------------------------------------------
    @classmethod
    def container_type(cls, fork: Fork, preset):
        """The underlying fork-specific container class."""
        if fork not in cls.FORKS:
            raise UnknownForkError(f"{cls.KIND} does not exist in fork {fork}")
        return getattr(fork_module(fork).build(preset), cls.KIND)

    @classmethod
    def from_fork(cls, fork: Fork, data):
        return cls(fork, data)

    @classmethod
    def wrap(cls, data, preset):
        """Wrap a bare container by detecting its fork from its class."""
        for fork in cls.FORKS:
            if type(data) is cls.container_type(fork, preset):
                return cls(fork, data)
        raise UnknownForkError(f"{type(data)!r} is not a known {cls.KIND}")

    # -- accessors (types/beacon_state.rs:331-420 equivalents) ---------------
    def version(self) -> Fork:
        return object.__getattribute__(self, "_fork")

    def __getattr__(self, name):
        # delegates every field accessor to the underlying container; fields
        # absent in this fork raise AttributeError, mirroring the Option-
        # returning accessors of the generated layer
        return getattr(object.__getattribute__(self, "data"), name)

    def __setattr__(self, name, value):
        setattr(object.__getattribute__(self, "data"), name, value)

    def __eq__(self, other):
        return (
            type(other) is type(self)
            and self.version() == other.version()
            and self.data == other.data
        )

    def copy(self):
        return type(self)(self.version(), self.data.copy())

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(fork={self.version()}, "
            f"data={type(self.data).__name__})"
        )

    # -- codec ---------------------------------------------------------------
    def serialize(self) -> bytes:
        return type(self.data).serialize(self.data)

    def hash_tree_root(self) -> bytes:
        return type(self.data).hash_tree_root(self.data)


class BeaconState(_Polymorphic):
    KIND = "BeaconState"


class SignedBeaconBlock(_Polymorphic):
    KIND = "SignedBeaconBlock"
