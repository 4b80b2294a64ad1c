"""bellatrix chain containers: execution payloads, blinded blocks, PowBlock.

Reference parity: ethereum-consensus/src/bellatrix/{execution_payload.rs,
beacon_state.rs, beacon_block.rs, blinded_beacon_block.rs, fork_choice.rs:4};
ported from ethereum_consensus_tpu/models/bellatrix/containers.py.

NOTE: no ``from __future__ import annotations`` — factory-local classes need
eager annotation evaluation (see phase0/containers.py).
"""

import functools
from types import SimpleNamespace

from ...config.presets import Preset
from ...primitives import (
    BlsSignature,
    Bytes32,
    ExecutionAddress,
    Hash32,
    Root,
    Slot,
    ValidatorIndex,
    U256,
)
from ...ssz import Bitvector, ByteList, ByteVector, Container, List, Vector, uint8, uint64
from ..altair import containers as altair_containers
from ..phase0 import containers as phase0_containers

__all__ = ["build", "PowBlock"]


class PowBlock(Container):
    """(fork_choice.rs:4) — the only fork-choice artifact in the reference."""

    block_hash: Hash32
    parent_hash: Hash32
    total_difficulty: U256


def execution_payload_to_header(payload, header_cls):
    """ExecutionPayloadHeader::try_from(&ExecutionPayload)
    (execution_payload.rs:86-129); works for every fork's payload pair
    because later forks only append parallel fields."""
    payload_fields = type(payload).__ssz_fields__
    fields = {}
    for name in header_cls.__ssz_fields__:
        base = name.removesuffix("_root")
        if name.endswith("_root") and base in payload_fields:
            # transactions / withdrawals / deposit_receipts /
            # withdrawal_requests lists → their hash_tree_root
            fields[name] = payload_fields[base].hash_tree_root(
                getattr(payload, base)
            )
        else:
            fields[name] = getattr(payload, name)
    return header_cls(**fields)


@functools.lru_cache(maxsize=None)
def build(preset: Preset) -> SimpleNamespace:
    """Build the preset-shaped bellatrix container set (extends altair's)."""
    base = altair_containers.build(preset)
    p = preset.phase0
    pb = preset.bellatrix

    Transaction = ByteList[pb.MAX_BYTES_PER_TRANSACTION]

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
        transactions: List[Transaction, pb.MAX_TRANSACTIONS_PER_PAYLOAD]

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

    ns = SimpleNamespace(**vars(base))
    ns.preset = preset
    ns.Transaction = Transaction
    ns.ExecutionPayload = ExecutionPayload
    ns.ExecutionPayloadHeader = ExecutionPayloadHeader
    ns.BeaconBlockBody = BeaconBlockBody
    ns.BeaconBlock = BeaconBlock
    ns.SignedBeaconBlock = SignedBeaconBlock
    ns.BlindedBeaconBlockBody = BlindedBeaconBlockBody
    ns.BlindedBeaconBlock = BlindedBeaconBlock
    ns.SignedBlindedBeaconBlock = SignedBlindedBeaconBlock
    ns.BeaconState = BeaconState
    ns.PowBlock = PowBlock
    return ns
