"""electra chain containers: EIP-7251 (maxEB/consolidations), EIP-6110
(deposit receipts), EIP-7002 (execution-layer withdrawal requests),
EIP-7549 (committee-spanning attestations).

Reference parity: ethereum-consensus/src/electra/{operations.rs:10-50,
beacon_state.rs:16-143, beacon_block.rs, execution_payload.rs}.

NOTE: no ``from __future__ import annotations`` — factory-local classes need
eager annotation evaluation (see phase0/containers.py).

Ported from ethereum_consensus_tpu/models/electra/containers.py.
"""

import functools
from types import SimpleNamespace

from ...config.presets import Preset
from ...primitives import (
    BlsPublicKey,
    BlsSignature,
    Bytes32,
    Epoch,
    ExecutionAddress,
    Gwei,
    Hash32,
    KzgCommitmentBytes,
    Root,
    Slot,
    U256,
    ValidatorIndex,
    WithdrawalIndex,
)
from ...ssz import Bitlist, Bitvector, ByteList, ByteVector, Container, List, Vector, uint8, uint64
from ..capella.containers import (
    EXECUTION_PAYLOAD_INDEX_FLOOR_LOG_2,
    SignedBlsToExecutionChange,
    Withdrawal,
)
from ..deneb import containers as deneb_containers
from ..phase0 import containers as phase0_containers

# EIP-7251 grows BeaconState to 37 fields, so the state tree deepens from
# 5 to 6 levels and every light-client branch grows by one node:
# finalized_checkpoint.root moves to gindex 169, the sync committees to
# 86/87 (spec: *_GINDEX_ELECTRA).  The altair constants deneb inherits
# (6/5/5) are one short here — electra redeclares its LightClient
# containers below with these widths.
FINALIZED_ROOT_INDEX_FLOOR_LOG_2 = 7
CURRENT_SYNC_COMMITTEE_INDEX_FLOOR_LOG_2 = 6
NEXT_SYNC_COMMITTEE_INDEX_FLOOR_LOG_2 = 6

__all__ = [
    "FINALIZED_ROOT_INDEX_FLOOR_LOG_2",
    "CURRENT_SYNC_COMMITTEE_INDEX_FLOOR_LOG_2",
    "NEXT_SYNC_COMMITTEE_INDEX_FLOOR_LOG_2",
    "DepositReceipt",
    "PendingBalanceDeposit",
    "PendingPartialWithdrawal",
    "PendingConsolidation",
    "ExecutionLayerWithdrawalRequest",
    "Consolidation",
    "SignedConsolidation",
    "build",
]


class DepositReceipt(Container):
    """(beacon_state.rs:16) — EIP-6110 in-protocol deposit."""

    public_key: BlsPublicKey
    withdrawal_credentials: Bytes32
    amount: Gwei
    signature: BlsSignature
    index: uint64


class PendingBalanceDeposit(Container):
    index: ValidatorIndex
    amount: Gwei


class PendingPartialWithdrawal(Container):
    index: ValidatorIndex
    amount: Gwei
    withdrawable_epoch: Epoch


class PendingConsolidation(Container):
    source_index: ValidatorIndex
    target_index: ValidatorIndex


class ExecutionLayerWithdrawalRequest(Container):
    """(beacon_state.rs:62) — EIP-7002."""

    source_address: ExecutionAddress
    validator_public_key: BlsPublicKey
    amount: Gwei


class Consolidation(Container):
    source_index: ValidatorIndex
    target_index: ValidatorIndex
    epoch: Epoch


class SignedConsolidation(Container):
    message: Consolidation
    signature: BlsSignature


@functools.lru_cache(maxsize=None)
def build(preset: Preset) -> SimpleNamespace:
    """Build the preset-shaped electra container set (extends deneb's)."""
    base = deneb_containers.build(preset)
    p = preset.phase0
    pb = preset.bellatrix
    pc = preset.capella
    pd = preset.deneb
    pe = preset.electra

    max_validators_per_slot = (
        p.MAX_VALIDATORS_PER_COMMITTEE * p.MAX_COMMITTEES_PER_SLOT
    )

    class IndexedAttestation(Container):
        """(operations.rs:18) — committee-spanning indices (EIP-7549)."""

        attesting_indices: List[uint64, max_validators_per_slot]
        data: phase0_containers.AttestationData
        signature: BlsSignature

    class Attestation(Container):
        """(operations.rs:28)"""

        aggregation_bits: Bitlist[max_validators_per_slot]
        data: phase0_containers.AttestationData
        committee_bits: Bitvector[p.MAX_COMMITTEES_PER_SLOT]
        signature: BlsSignature

    class AttesterSlashing(Container):
        attestation_1: IndexedAttestation
        attestation_2: IndexedAttestation

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
        blob_gas_used: uint64
        excess_blob_gas: uint64
        deposit_receipts: List[DepositReceipt, pe.MAX_DEPOSIT_RECEIPTS_PER_PAYLOAD]
        withdrawal_requests: List[
            ExecutionLayerWithdrawalRequest, pe.MAX_WITHDRAWAL_REQUESTS_PER_PAYLOAD
        ]

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
        blob_gas_used: uint64
        excess_blob_gas: uint64
        deposit_receipts_root: Root
        withdrawal_requests_root: Root

    class BeaconBlockBody(Container):
        randao_reveal: BlsSignature
        eth1_data: phase0_containers.Eth1Data
        graffiti: Bytes32
        proposer_slashings: List[
            phase0_containers.ProposerSlashing, p.MAX_PROPOSER_SLASHINGS
        ]
        attester_slashings: List[
            AttesterSlashing, pe.MAX_ATTESTER_SLASHINGS_ELECTRA
        ]
        attestations: List[Attestation, pe.MAX_ATTESTATIONS_ELECTRA]
        deposits: List[phase0_containers.Deposit, p.MAX_DEPOSITS]
        voluntary_exits: List[
            phase0_containers.SignedVoluntaryExit, p.MAX_VOLUNTARY_EXITS
        ]
        sync_aggregate: base.SyncAggregate
        execution_payload: ExecutionPayload
        bls_to_execution_changes: List[
            SignedBlsToExecutionChange, pc.MAX_BLS_TO_EXECUTION_CHANGES
        ]
        blob_kzg_commitments: List[
            KzgCommitmentBytes, pd.MAX_BLOB_COMMITMENTS_PER_BLOCK
        ]
        consolidations: List[SignedConsolidation, pe.MAX_CONSOLIDATIONS]

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
        attester_slashings: List[
            AttesterSlashing, pe.MAX_ATTESTER_SLASHINGS_ELECTRA
        ]
        attestations: List[Attestation, pe.MAX_ATTESTATIONS_ELECTRA]
        deposits: List[phase0_containers.Deposit, p.MAX_DEPOSITS]
        voluntary_exits: List[
            phase0_containers.SignedVoluntaryExit, p.MAX_VOLUNTARY_EXITS
        ]
        sync_aggregate: base.SyncAggregate
        execution_payload_header: ExecutionPayloadHeader
        bls_to_execution_changes: List[
            SignedBlsToExecutionChange, pc.MAX_BLS_TO_EXECUTION_CHANGES
        ]
        blob_kzg_commitments: List[
            KzgCommitmentBytes, pd.MAX_BLOB_COMMITMENTS_PER_BLOCK
        ]
        consolidations: List[SignedConsolidation, pe.MAX_CONSOLIDATIONS]

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
        historical_summaries: List[
            phase0_containers.HistoricalSummary, p.HISTORICAL_ROOTS_LIMIT
        ]
        deposit_receipts_start_index: uint64
        deposit_balance_to_consume: Gwei
        exit_balance_to_consume: Gwei
        earliest_exit_epoch: Epoch
        consolidation_balance_to_consume: Gwei
        earliest_consolidation_epoch: Epoch
        pending_balance_deposits: List[
            PendingBalanceDeposit, pe.PENDING_BALANCE_DEPOSITS_LIMIT
        ]
        pending_partial_withdrawals: List[
            PendingPartialWithdrawal, pe.PENDING_PARTIAL_WITHDRAWALS_LIMIT
        ]
        pending_consolidations: List[
            PendingConsolidation, pe.PENDING_CONSOLIDATIONS_LIMIT
        ]

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
    ns.DepositReceipt = DepositReceipt
    ns.PendingBalanceDeposit = PendingBalanceDeposit
    ns.PendingPartialWithdrawal = PendingPartialWithdrawal
    ns.PendingConsolidation = PendingConsolidation
    ns.ExecutionLayerWithdrawalRequest = ExecutionLayerWithdrawalRequest
    ns.Consolidation = Consolidation
    ns.SignedConsolidation = SignedConsolidation
    ns.IndexedAttestation = IndexedAttestation
    ns.Attestation = Attestation
    ns.AttesterSlashing = AttesterSlashing
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
