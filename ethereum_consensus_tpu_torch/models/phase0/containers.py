"""phase0 chain containers.

Reference parity: ethereum-consensus/src/phase0/{beacon_state.rs:49,
beacon_block.rs:99, operations.rs:13-140, validator.rs:10}.

Preset-independent containers are plain module-level classes. Containers
whose shapes depend on preset bounds are built by ``build(preset)`` — the
analogue of the reference's const-generic monomorphization: each preset
yields a distinct set of container classes with static shapes.

NOTE: no ``from __future__ import annotations`` here — the factory-local
classes need eager annotation evaluation to see the enclosing ``p`` preset
bounds and sibling classes.
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
    Root,
    Slot,
    ValidatorIndex,
    Version,
)
from ...signing import SigningData
from ...ssz import (
    Bitlist,
    Bitvector,
    Container,
    List,
    Vector,
    boolean,
    uint64,
)

JUSTIFICATION_BITS_LENGTH = 4

__all__ = [
    "Fork",
    "ForkData",
    "Checkpoint",
    "Validator",
    "AttestationData",
    "Eth1Data",
    "DepositMessage",
    "DepositData",
    "DepositProof",
    "Deposit",
    "BeaconBlockHeader",
    "SignedBeaconBlockHeader",
    "ProposerSlashing",
    "VoluntaryExit",
    "SignedVoluntaryExit",
    "HistoricalSummary",
    "SigningData",
    "build",
    "DEPOSIT_CONTRACT_TREE_DEPTH",
]

DEPOSIT_CONTRACT_TREE_DEPTH = 32


class Fork(Container):
    previous_version: Version
    current_version: Version
    epoch: Epoch


class ForkData(Container):
    current_version: Version
    genesis_validators_root: Root


class Checkpoint(Container):
    epoch: Epoch
    root: Root


class Validator(Container):
    public_key: BlsPublicKey
    withdrawal_credentials: Bytes32
    effective_balance: Gwei
    slashed: boolean
    activation_eligibility_epoch: Epoch
    activation_epoch: Epoch
    exit_epoch: Epoch
    withdrawable_epoch: Epoch


class AttestationData(Container):
    slot: Slot
    index: uint64
    beacon_block_root: Root
    source: Checkpoint
    target: Checkpoint


class Eth1Data(Container):
    deposit_root: Root
    deposit_count: uint64
    block_hash: Bytes32


class DepositMessage(Container):
    public_key: BlsPublicKey
    withdrawal_credentials: Bytes32
    amount: Gwei


class DepositData(Container):
    public_key: BlsPublicKey
    withdrawal_credentials: Bytes32
    amount: Gwei
    signature: BlsSignature


DepositProof = Vector[Root, DEPOSIT_CONTRACT_TREE_DEPTH + 1]


class Deposit(Container):
    proof: DepositProof
    data: DepositData


class BeaconBlockHeader(Container):
    slot: Slot
    proposer_index: ValidatorIndex
    parent_root: Root
    state_root: Root
    body_root: Root


class SignedBeaconBlockHeader(Container):
    message: BeaconBlockHeader
    signature: BlsSignature


class ProposerSlashing(Container):
    signed_header_1: SignedBeaconBlockHeader
    signed_header_2: SignedBeaconBlockHeader


class VoluntaryExit(Container):
    epoch: Epoch
    validator_index: ValidatorIndex


class SignedVoluntaryExit(Container):
    message: VoluntaryExit
    signature: BlsSignature


class HistoricalSummary(Container):
    block_summary_root: Root
    state_summary_root: Root


@functools.lru_cache(maxsize=None)
def build(preset: Preset) -> SimpleNamespace:
    """Build the preset-shaped phase0 container set."""
    p = preset.phase0

    class IndexedAttestation(Container):
        attesting_indices: List[uint64, p.MAX_VALIDATORS_PER_COMMITTEE]
        data: AttestationData
        signature: BlsSignature

    class PendingAttestation(Container):
        aggregation_bits: Bitlist[p.MAX_VALIDATORS_PER_COMMITTEE]
        data: AttestationData
        inclusion_delay: Slot
        proposer_index: ValidatorIndex

    class Attestation(Container):
        aggregation_bits: Bitlist[p.MAX_VALIDATORS_PER_COMMITTEE]
        data: AttestationData
        signature: BlsSignature

    class AttesterSlashing(Container):
        attestation_1: IndexedAttestation
        attestation_2: IndexedAttestation

    class HistoricalBatch(Container):
        block_roots: Vector[Root, p.SLOTS_PER_HISTORICAL_ROOT]
        state_roots: Vector[Root, p.SLOTS_PER_HISTORICAL_ROOT]

    class BeaconBlockBody(Container):
        randao_reveal: BlsSignature
        eth1_data: Eth1Data
        graffiti: Bytes32
        proposer_slashings: List[ProposerSlashing, p.MAX_PROPOSER_SLASHINGS]
        attester_slashings: List[AttesterSlashing, p.MAX_ATTESTER_SLASHINGS]
        attestations: List[Attestation, p.MAX_ATTESTATIONS]
        deposits: List[Deposit, p.MAX_DEPOSITS]
        voluntary_exits: List[SignedVoluntaryExit, p.MAX_VOLUNTARY_EXITS]

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
        fork: Fork
        latest_block_header: BeaconBlockHeader
        block_roots: Vector[Root, p.SLOTS_PER_HISTORICAL_ROOT]
        state_roots: Vector[Root, p.SLOTS_PER_HISTORICAL_ROOT]
        historical_roots: List[Root, p.HISTORICAL_ROOTS_LIMIT]
        eth1_data: Eth1Data
        eth1_data_votes: List[
            Eth1Data, p.EPOCHS_PER_ETH1_VOTING_PERIOD * p.SLOTS_PER_EPOCH
        ]
        eth1_deposit_index: uint64
        validators: List[Validator, p.VALIDATOR_REGISTRY_LIMIT]
        balances: List[Gwei, p.VALIDATOR_REGISTRY_LIMIT]
        randao_mixes: Vector[Bytes32, p.EPOCHS_PER_HISTORICAL_VECTOR]
        slashings: Vector[Gwei, p.EPOCHS_PER_SLASHINGS_VECTOR]
        previous_epoch_attestations: List[
            PendingAttestation, p.MAX_ATTESTATIONS * p.SLOTS_PER_EPOCH
        ]
        current_epoch_attestations: List[
            PendingAttestation, p.MAX_ATTESTATIONS * p.SLOTS_PER_EPOCH
        ]
        justification_bits: Bitvector[JUSTIFICATION_BITS_LENGTH]
        previous_justified_checkpoint: Checkpoint
        current_justified_checkpoint: Checkpoint
        finalized_checkpoint: Checkpoint

    class Eth1Block(Container):
        timestamp: uint64
        deposit_root: Root
        deposit_count: uint64

    class AggregateAndProof(Container):
        aggregator_index: ValidatorIndex
        aggregate: Attestation
        selection_proof: BlsSignature

    class SignedAggregateAndProof(Container):
        message: AggregateAndProof
        signature: BlsSignature

    return SimpleNamespace(
        preset=preset,
        # re-export the preset-independent classes for a flat namespace
        Fork=Fork,
        ForkData=ForkData,
        Checkpoint=Checkpoint,
        Validator=Validator,
        AttestationData=AttestationData,
        Eth1Data=Eth1Data,
        DepositMessage=DepositMessage,
        DepositData=DepositData,
        Deposit=Deposit,
        BeaconBlockHeader=BeaconBlockHeader,
        SignedBeaconBlockHeader=SignedBeaconBlockHeader,
        ProposerSlashing=ProposerSlashing,
        VoluntaryExit=VoluntaryExit,
        SignedVoluntaryExit=SignedVoluntaryExit,
        HistoricalSummary=HistoricalSummary,
        SigningData=SigningData,
        IndexedAttestation=IndexedAttestation,
        PendingAttestation=PendingAttestation,
        Attestation=Attestation,
        AttesterSlashing=AttesterSlashing,
        HistoricalBatch=HistoricalBatch,
        BeaconBlockBody=BeaconBlockBody,
        BeaconBlock=BeaconBlock,
        SignedBeaconBlock=SignedBeaconBlock,
        BeaconState=BeaconState,
        Eth1Block=Eth1Block,
        AggregateAndProof=AggregateAndProof,
        SignedAggregateAndProof=SignedAggregateAndProof,
    )
