"""capella chain containers: withdrawals, BLS→execution changes, capella
payloads (with withdrawals), capella light client (execution header).

Reference parity: ethereum-consensus/src/capella/{withdrawal.rs,
bls_to_execution_change.rs, beacon_state.rs:60-63, light_client.rs:13-70};
ported from ethereum_consensus_tpu/models/capella/containers.py.

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
    ExecutionAddress,
    Gwei,
    Hash32,
    Root,
    Slot,
    U256,
    ValidatorIndex,
    WithdrawalIndex,
)
from ...ssz import Bitvector, ByteList, ByteVector, Container, List, Vector, uint8, uint64
from ..altair.constants import (
    CURRENT_SYNC_COMMITTEE_INDEX_FLOOR_LOG_2,
    FINALIZED_ROOT_INDEX_FLOOR_LOG_2,
    NEXT_SYNC_COMMITTEE_INDEX_FLOOR_LOG_2,
)
from ..bellatrix import containers as bellatrix_containers
from ..phase0 import containers as phase0_containers
from ..phase0.containers import HistoricalSummary

__all__ = [
    "Withdrawal",
    "BlsToExecutionChange",
    "SignedBlsToExecutionChange",
    "EXECUTION_PAYLOAD_INDEX",
    "EXECUTION_PAYLOAD_INDEX_FLOOR_LOG_2",
    "build",
]

# generalized index of execution payload header in the capella block body
# (light_client.rs:13-14)
EXECUTION_PAYLOAD_INDEX = 25
EXECUTION_PAYLOAD_INDEX_FLOOR_LOG_2 = 4


class Withdrawal(Container):
    index: WithdrawalIndex
    validator_index: ValidatorIndex
    address: ExecutionAddress
    amount: Gwei


class BlsToExecutionChange(Container):
    validator_index: ValidatorIndex
    from_bls_public_key: BlsPublicKey
    to_execution_address: ExecutionAddress


class SignedBlsToExecutionChange(Container):
    message: BlsToExecutionChange
    signature: BlsSignature


@functools.lru_cache(maxsize=None)
def build(preset: Preset) -> SimpleNamespace:
    """Build the preset-shaped capella container set (extends bellatrix's)."""
    base = bellatrix_containers.build(preset)
    p = preset.phase0
    pb = preset.bellatrix
    pc = preset.capella

    class ExecutionPayload(Container):
        parent_hash: Hash32
        fee_recipient: ExecutionAddress
        state_root: Bytes32
        receipts_root: Bytes32
        logs_bloom: ByteVector[pb.BYTES_PER_LOGS_BLOOM]
        prev_randao: Bytes32
        block_number: uint64
        gas_limit: uint64
        gas_used: uint64
        timestamp: uint64
        extra_data: ByteList[pb.MAX_EXTRA_DATA_BYTES]
        base_fee_per_gas: U256
        block_hash: Hash32
        transactions: List[base.Transaction, pb.MAX_TRANSACTIONS_PER_PAYLOAD]
        withdrawals: List[Withdrawal, pc.MAX_WITHDRAWALS_PER_PAYLOAD]

    class ExecutionPayloadHeader(Container):
        parent_hash: Hash32
        fee_recipient: ExecutionAddress
        state_root: Bytes32
        receipts_root: Bytes32
        logs_bloom: ByteVector[pb.BYTES_PER_LOGS_BLOOM]
        prev_randao: Bytes32
        block_number: uint64
        gas_limit: uint64
        gas_used: uint64
        timestamp: uint64
        extra_data: ByteList[pb.MAX_EXTRA_DATA_BYTES]
        base_fee_per_gas: U256
        block_hash: Hash32
        transactions_root: Root
        withdrawals_root: Root

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
        sync_aggregate: base.SyncAggregate
        execution_payload: ExecutionPayload
        bls_to_execution_changes: List[
            SignedBlsToExecutionChange, pc.MAX_BLS_TO_EXECUTION_CHANGES
        ]

    class BeaconBlock(Container):
        slot: Slot
        proposer_index: ValidatorIndex
        parent_root: Root
        state_root: Root
        body: BeaconBlockBody

    class SignedBeaconBlock(Container):
        message: BeaconBlock
        signature: BlsSignature

    class BlindedBeaconBlockBody(Container):
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
        sync_aggregate: base.SyncAggregate
        execution_payload_header: ExecutionPayloadHeader
        bls_to_execution_changes: List[
            SignedBlsToExecutionChange, pc.MAX_BLS_TO_EXECUTION_CHANGES
        ]

    class BlindedBeaconBlock(Container):
        slot: Slot
        proposer_index: ValidatorIndex
        parent_root: Root
        state_root: Root
        body: BlindedBeaconBlockBody

    class SignedBlindedBeaconBlock(Container):
        message: BlindedBeaconBlock
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
        current_sync_committee: base.SyncCommittee
        next_sync_committee: base.SyncCommittee
        latest_execution_payload_header: ExecutionPayloadHeader
        next_withdrawal_index: WithdrawalIndex
        next_withdrawal_validator_index: ValidatorIndex
        historical_summaries: List[HistoricalSummary, p.HISTORICAL_ROOTS_LIMIT]

    class LightClientHeader(Container):
        beacon: phase0_containers.BeaconBlockHeader
        execution: ExecutionPayloadHeader
        execution_branch: Vector[Bytes32, EXECUTION_PAYLOAD_INDEX_FLOOR_LOG_2]

    class LightClientBootstrap(Container):
        header: LightClientHeader
        current_sync_committee: base.SyncCommittee
        current_sync_committee_branch: Vector[
            Bytes32, CURRENT_SYNC_COMMITTEE_INDEX_FLOOR_LOG_2
        ]

    class LightClientUpdate(Container):
        attested_header: LightClientHeader
        next_sync_committee: base.SyncCommittee
        next_sync_committee_branch: Vector[
            Bytes32, NEXT_SYNC_COMMITTEE_INDEX_FLOOR_LOG_2
        ]
        finalized_header: LightClientHeader
        finality_branch: Vector[Bytes32, FINALIZED_ROOT_INDEX_FLOOR_LOG_2]
        sync_aggregate: base.SyncAggregate
        signature_slot: Slot

    class LightClientFinalityUpdate(Container):
        attested_header: LightClientHeader
        finalized_header: LightClientHeader
        finality_branch: Vector[Bytes32, FINALIZED_ROOT_INDEX_FLOOR_LOG_2]
        sync_aggregate: base.SyncAggregate
        signature_slot: Slot

    class LightClientOptimisticUpdate(Container):
        attested_header: LightClientHeader
        sync_aggregate: base.SyncAggregate
        signature_slot: Slot

    ns = SimpleNamespace(**vars(base))
    ns.preset = preset
    ns.Withdrawal = Withdrawal
    ns.BlsToExecutionChange = BlsToExecutionChange
    ns.SignedBlsToExecutionChange = SignedBlsToExecutionChange
    ns.HistoricalSummary = HistoricalSummary
    ns.ExecutionPayload = ExecutionPayload
    ns.ExecutionPayloadHeader = ExecutionPayloadHeader
    ns.BeaconBlockBody = BeaconBlockBody
    ns.BeaconBlock = BeaconBlock
    ns.SignedBeaconBlock = SignedBeaconBlock
    ns.BlindedBeaconBlockBody = BlindedBeaconBlockBody
    ns.BlindedBeaconBlock = BlindedBeaconBlock
    ns.SignedBlindedBeaconBlock = SignedBlindedBeaconBlock
    ns.BeaconState = BeaconState
    ns.LightClientHeader = LightClientHeader
    ns.LightClientBootstrap = LightClientBootstrap
    ns.LightClientUpdate = LightClientUpdate
    ns.LightClientFinalityUpdate = LightClientFinalityUpdate
    ns.LightClientOptimisticUpdate = LightClientOptimisticUpdate
    return ns
