"""altair chain containers: sync committees, participation-flag state,
light-client objects.

Reference parity: ethereum-consensus/src/altair/{beacon_state.rs:13,
beacon_block.rs:13, sync.rs:9-23, validator.rs, light_client.rs:19-57};
ported from ethereum_consensus_tpu/models/altair/containers.py.

Same factory pattern as phase0: preset-independent classes at module scope,
preset-shaped classes from ``build(preset)``. The altair factory reuses the
phase0 factory for everything the fork does not redefine (the fork-diff
composition that replaces the reference's spec-gen AST merge).

NOTE: no ``from __future__ import annotations`` — factory-local classes need
eager annotation evaluation (see phase0/containers.py).
"""

import functools
from types import SimpleNamespace

from ...config.presets import Preset
from ...primitives import (
    BlsPublicKey,
    BlsSignature,
    Bytes32,
    Root,
    Slot,
    ValidatorIndex,
)
from ...ssz import Bitvector, Container, List, Vector, uint8, uint64
from ..phase0 import containers as phase0_containers
from .constants import (
    CURRENT_SYNC_COMMITTEE_INDEX_FLOOR_LOG_2,
    FINALIZED_ROOT_INDEX_FLOOR_LOG_2,
    NEXT_SYNC_COMMITTEE_INDEX_FLOOR_LOG_2,
    SYNC_COMMITTEE_SUBNET_COUNT,
)

__all__ = ["SyncCommitteeMessage", "SyncAggregatorSelectionData",
           "LightClientHeader", "build"]


class SyncCommitteeMessage(Container):
    slot: Slot
    beacon_block_root: Root
    validator_index: ValidatorIndex
    signature: BlsSignature


class SyncAggregatorSelectionData(Container):
    slot: Slot
    subcommittee_index: uint64


class LightClientHeader(Container):
    beacon: phase0_containers.BeaconBlockHeader


@functools.lru_cache(maxsize=None)
def build(preset: Preset) -> SimpleNamespace:
    """Build the preset-shaped altair container set (extends phase0's)."""
    base = phase0_containers.build(preset)
    p = preset.phase0
    pa = preset.altair

    class SyncAggregate(Container):
        sync_committee_bits: Bitvector[pa.SYNC_COMMITTEE_SIZE]
        sync_committee_signature: BlsSignature

    class SyncCommittee(Container):
        public_keys: Vector[BlsPublicKey, pa.SYNC_COMMITTEE_SIZE]
        aggregate_public_key: BlsPublicKey

    class BeaconBlockBody(Container):
        randao_reveal: BlsSignature
        eth1_data: phase0_containers.Eth1Data
        graffiti: Bytes32
        proposer_slashings: List[
            phase0_containers.ProposerSlashing, p.MAX_PROPOSER_SLASHINGS
        ]
        attester_slashings: List[base.AttesterSlashing, p.MAX_ATTESTER_SLASHINGS]
        attestations: List[base.Attestation, p.MAX_ATTESTATIONS]
        deposits: List[phase0_containers.Deposit, p.MAX_DEPOSITS]
        voluntary_exits: List[
            phase0_containers.SignedVoluntaryExit, p.MAX_VOLUNTARY_EXITS
        ]
        sync_aggregate: SyncAggregate

    class BeaconBlock(Container):
        slot: Slot
        proposer_index: ValidatorIndex
        parent_root: Root
        state_root: Root
        body: BeaconBlockBody

    class SignedBeaconBlock(Container):
        message: BeaconBlock
        signature: BlsSignature

    class BeaconState(Container):
        genesis_time: uint64
        genesis_validators_root: Root
        slot: Slot
        fork: phase0_containers.Fork
        latest_block_header: phase0_containers.BeaconBlockHeader
        block_roots: Vector[Root, p.SLOTS_PER_HISTORICAL_ROOT]
        state_roots: Vector[Root, p.SLOTS_PER_HISTORICAL_ROOT]
        historical_roots: List[Root, p.HISTORICAL_ROOTS_LIMIT]
        eth1_data: phase0_containers.Eth1Data
        eth1_data_votes: List[
            phase0_containers.Eth1Data,
            p.EPOCHS_PER_ETH1_VOTING_PERIOD * p.SLOTS_PER_EPOCH,
        ]
        eth1_deposit_index: uint64
        validators: List[phase0_containers.Validator, p.VALIDATOR_REGISTRY_LIMIT]
        balances: List[uint64, p.VALIDATOR_REGISTRY_LIMIT]
        randao_mixes: Vector[Bytes32, p.EPOCHS_PER_HISTORICAL_VECTOR]
        slashings: Vector[uint64, p.EPOCHS_PER_SLASHINGS_VECTOR]
        previous_epoch_participation: List[uint8, p.VALIDATOR_REGISTRY_LIMIT]
        current_epoch_participation: List[uint8, p.VALIDATOR_REGISTRY_LIMIT]
        justification_bits: Bitvector[phase0_containers.JUSTIFICATION_BITS_LENGTH]
        previous_justified_checkpoint: phase0_containers.Checkpoint
        current_justified_checkpoint: phase0_containers.Checkpoint
        finalized_checkpoint: phase0_containers.Checkpoint
        inactivity_scores: List[uint64, p.VALIDATOR_REGISTRY_LIMIT]
        current_sync_committee: SyncCommittee
        next_sync_committee: SyncCommittee

    sync_subcommittee_size = pa.SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT

    class SyncCommitteeContribution(Container):
        slot: Slot
        beacon_block_root: Root
        subcommittee_index: uint64
        aggregation_bits: Bitvector[sync_subcommittee_size]
        signature: BlsSignature

    class ContributionAndProof(Container):
        aggregator_index: ValidatorIndex
        contribution: SyncCommitteeContribution
        selection_proof: BlsSignature

    class SignedContributionAndProof(Container):
        message: ContributionAndProof
        signature: BlsSignature

    class LightClientBootstrap(Container):
        header: LightClientHeader
        current_sync_committee: SyncCommittee
        current_sync_committee_branch: Vector[
            Bytes32, CURRENT_SYNC_COMMITTEE_INDEX_FLOOR_LOG_2
        ]

    class LightClientUpdate(Container):
        attested_header: LightClientHeader
        next_sync_committee: SyncCommittee
        next_sync_committee_branch: Vector[
            Bytes32, NEXT_SYNC_COMMITTEE_INDEX_FLOOR_LOG_2
        ]
        finalized_header: LightClientHeader
        finality_branch: Vector[Bytes32, FINALIZED_ROOT_INDEX_FLOOR_LOG_2]
        sync_aggregate: SyncAggregate
        signature_slot: Slot

    class LightClientFinalityUpdate(Container):
        attested_header: LightClientHeader
        finalized_header: LightClientHeader
        finality_branch: Vector[Bytes32, FINALIZED_ROOT_INDEX_FLOOR_LOG_2]
        sync_aggregate: SyncAggregate
        signature_slot: Slot

    class LightClientOptimisticUpdate(Container):
        attested_header: LightClientHeader
        sync_aggregate: SyncAggregate
        signature_slot: Slot

    ns = SimpleNamespace(**vars(base))
    ns.preset = preset
    ns.SyncAggregate = SyncAggregate
    ns.SyncCommittee = SyncCommittee
    ns.BeaconBlockBody = BeaconBlockBody
    ns.BeaconBlock = BeaconBlock
    ns.SignedBeaconBlock = SignedBeaconBlock
    ns.BeaconState = BeaconState
    ns.SyncCommitteeMessage = SyncCommitteeMessage
    ns.SyncAggregatorSelectionData = SyncAggregatorSelectionData
    ns.SyncCommitteeContribution = SyncCommitteeContribution
    ns.ContributionAndProof = ContributionAndProof
    ns.SignedContributionAndProof = SignedContributionAndProof
    ns.LightClientHeader = LightClientHeader
    ns.LightClientBootstrap = LightClientBootstrap
    ns.LightClientUpdate = LightClientUpdate
    ns.LightClientFinalityUpdate = LightClientFinalityUpdate
    ns.LightClientOptimisticUpdate = LightClientOptimisticUpdate
    return ns
