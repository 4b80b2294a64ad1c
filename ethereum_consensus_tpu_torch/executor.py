"""Executor — polymorphic block application.

Reference parity: ethereum-consensus/src/state_transition/executor.rs:8-532
— ``apply_block`` dispatches on the block's fork. The reference also
advances the state through every intermediate fork boundary
(executor.rs:210-302); the port carries phase0 only, so no upgrade runs
yet: a block of a later fork raises ``UnknownForkError`` (an unknown
container) or ``IncompatibleForksError`` (older than the state).
"""

from __future__ import annotations

from .error import IncompatibleForksError
from .models.transition import Validation
from .types import BeaconState, SignedBeaconBlock, fork_module

__all__ = ["Executor", "Validation"]


class Executor:
    """Owns a polymorphic ``BeaconState`` + ``Context`` (executor.rs:8)."""

    def __init__(self, state: BeaconState, context):
        if not isinstance(state, BeaconState):
            state = BeaconState.wrap(state, context.preset)
        self.state = state
        self.context = context

    def apply_block(self, signed_block) -> None:
        """(executor.rs:113)"""
        self.apply_block_with_validation(signed_block, Validation.ENABLED)

    def apply_block_with_validation(self, signed_block, validation) -> None:
        """(executor.rs:135)"""
        if not isinstance(signed_block, SignedBeaconBlock):
            signed_block = SignedBeaconBlock.wrap(signed_block, self.context.preset)

        source = self.state.version()
        destination = signed_block.version()
        if destination < source:
            raise IncompatibleForksError(destination, source)
        state = self.state.data
        fork_module(destination).state_transition.state_transition(
            state, signed_block.data, self.context, validation
        )
        self.state = BeaconState.from_fork(destination, state)
