"""Executor — polymorphic block application with inline fork upgrades.

Reference parity: ethereum-consensus/src/state_transition/executor.rs:8-532
— ``apply_block`` dispatches on the block's fork, advancing the state
through every intermediate fork boundary (process_slots to the fork slot,
then upgrade_to_X, executor.rs:210-302), including the corner where the
block sits exactly on the upgrade slot (state_transition_block_in_slot,
executor.rs:215-224). Ported from ethereum_consensus_tpu/executor.py. The
port carries phase0 through electra: a block of no known fork raises
``UnknownForkError`` (an unknown container), one older than the state
``IncompatibleForksError``.

Beyond the reference: ``stream`` replays an iterable of blocks through
the chain pipeline (pipeline/engine.py) — speculative host application
overlapped with windowed cross-block signature verification — with
observable semantics identical to an ``apply_block`` loop.
"""

from __future__ import annotations

from .error import IncompatibleForksError
from .fork import Fork
from .models.transition import Validation
from .types import FORK_SEQUENCE, BeaconState, SignedBeaconBlock, fork_module
from .utils import trace

__all__ = ["Executor", "Validation"]

_UPGRADE_FN = {
    Fork.ALTAIR: "upgrade_to_altair",
    Fork.BELLATRIX: "upgrade_to_bellatrix",
    Fork.CAPELLA: "upgrade_to_capella",
    Fork.DENEB: "upgrade_to_deneb",
    Fork.ELECTRA: "upgrade_to_electra",
}


class Executor:
    """Owns a polymorphic ``BeaconState`` + ``Context`` (executor.rs:8)."""

    def __init__(self, state: BeaconState, context):
        if not isinstance(state, BeaconState):
            state = BeaconState.wrap(state, context.preset)
        self.state = state
        self.context = context

    def apply_block(self, signed_block) -> None:
        """(executor.rs:113)"""
        # wrapped first: a container of no known fork raises UnknownForkError
        # before the span reads its slot
        if not isinstance(signed_block, SignedBeaconBlock):
            signed_block = SignedBeaconBlock.wrap(signed_block, self.context.preset)
        with trace.span("executor.apply_block", slot=int(signed_block.data.message.slot)):
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
        fork = source
        # advance through each intermediate fork boundary
        # (executor.rs:210-302): slots to the fork slot under the old fork's
        # rules, then the upgrade function
        for next_fork in FORK_SEQUENCE[source + 1 : destination + 1]:
            fork_slot = (
                self.context.fork_activation_epoch(next_fork)
                * self.context.SLOTS_PER_EPOCH
            )
            if state.slot < fork_slot:
                fork_module(fork).slot_processing.process_slots(
                    state, fork_slot, self.context
                )
            upgrade = getattr(fork_module(next_fork), _UPGRADE_FN[next_fork])
            state = upgrade(state, self.context)
            fork = next_fork

        transition = fork_module(destination).state_transition
        if fork != source and signed_block.data.message.slot == state.slot:
            # block lands exactly on the upgrade slot (executor.rs:215-224)
            transition.state_transition_block_in_slot(
                state, signed_block.data, validation, self.context
            )
        else:
            transition.state_transition(
                state, signed_block.data, self.context, validation
            )

        self.state = BeaconState.from_fork(destination, state)

    def stream(
        self,
        signed_blocks,
        policy=None,
        validation: Validation = Validation.ENABLED,
        stats=None,
    ):
        """Apply an iterable of signed blocks through the chain pipeline
        (``pipeline.ChainPipeline``): speculative host application
        overlapped with windowed cross-block signature verification on a
        background worker. Returns the run's ``PipelineStats``.

        Observable semantics match a loop of ``apply_block``: the same
        final state bit-for-bit on success; on an invalid block, the same
        structured error raises and ``self.state`` is the last state
        whose signatures fully verified (not mid-block garbage). A device
        failure raises ``PipelineBrokenError`` chained from it, with
        ``self.state`` at the same committed position."""
        from .pipeline import ChainPipeline

        pipeline = ChainPipeline(
            self, policy=policy, validation=validation, stats=stats
        )
        for signed_block in signed_blocks:
            pipeline.submit(signed_block)
        return pipeline.close()
