"""deneb chain containers: blobs/EIP-4844 — Blob, BlobSidecar, blob-gas
payload fields, blob KZG commitments in the block body.

Reference parity: ethereum-consensus/src/deneb/{blob_sidecar.rs:13-44,
execution_payload.rs, beacon_state.rs, beacon_block.rs, light_client.rs};
ported from ethereum_consensus_tpu/models/deneb/containers.py.

NOTE: no ``from __future__ import annotations`` — factory-local classes need
eager annotation evaluation (see phase0/containers.py).
"""

import functools
from types import SimpleNamespace

from ...config.presets import Preset
from ...primitives import (
    BlobIndex,
    BlsPublicKey,
    BlsSignature,
    Bytes32,
    ExecutionAddress,
    Hash32,
    KzgCommitmentBytes,
    KzgProofBytes,
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
from ..capella import containers as capella_containers
from ..capella.containers import (
    EXECUTION_PAYLOAD_INDEX_FLOOR_LOG_2,
    SignedBlsToExecutionChange,
    Withdrawal,
)
from ..phase0 import containers as phase0_containers
from ..phase0.containers import SignedBeaconBlockHeader

__all__ = ["BlobIdentifier", "BYTES_PER_FIELD_ELEMENT", "build"]

BYTES_PER_FIELD_ELEMENT = 32


class BlobIdentifier(Container):
    """(blob_sidecar.rs:18)"""

    block_root: Root
    index: BlobIndex


@functools.lru_cache(maxsize=None)
def build(preset: Preset) -> SimpleNamespace:
    """Build the preset-shaped deneb container set (extends capella's)."""
    base = capella_containers.build(preset)
    p = preset.phase0
    pb = preset.bellatrix
    pc = preset.capella
    pd = preset.deneb

    bytes_per_blob = BYTES_PER_FIELD_ELEMENT * pd.FIELD_ELEMENTS_PER_BLOB
    Blob = ByteVector[bytes_per_blob]

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
        blob_kzg_commitments: List[
            KzgCommitmentBytes, pd.MAX_BLOB_COMMITMENTS_PER_BLOCK
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
        blob_kzg_commitments: List[
            KzgCommitmentBytes, pd.MAX_BLOB_COMMITMENTS_PER_BLOCK
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
        historical_summaries: List[
            phase0_containers.HistoricalSummary, p.HISTORICAL_ROOTS_LIMIT
        ]

    class BlobsBundle(Container):
        """(blob_sidecar.rs:25) — engine-API bundle; bounded per block."""

        commitments: List[KzgCommitmentBytes, pd.MAX_BLOB_COMMITMENTS_PER_BLOCK]
        proofs: List[KzgProofBytes, pd.MAX_BLOB_COMMITMENTS_PER_BLOCK]
        blobs: List[Blob, pd.MAX_BLOB_COMMITMENTS_PER_BLOCK]

    class BlobSidecar(Container):
        """(blob_sidecar.rs:34)"""

        index: BlobIndex
        blob: Blob
        kzg_commitment: KzgCommitmentBytes
        kzg_proof: KzgProofBytes
        signed_block_header: SignedBeaconBlockHeader
        kzg_commitment_inclusion_proof: Vector[
            Bytes32, pd.KZG_COMMITMENT_INCLUSION_PROOF_DEPTH
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
    ns.Blob = Blob
    ns.BlobIdentifier = BlobIdentifier
    ns.BlobsBundle = BlobsBundle
    ns.BlobSidecar = BlobSidecar
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
