"""Fork-generic genesis construction.

Every fork's ``initialize_beacon_state_from_eth1`` repeats one skeleton
(phase0/genesis.rs:15 re-spun per fork by spec-gen): build the empty state
at the fork's version, fold in bootstrap deposits against an incremental
deposit tree, activate full-balance validators, set the validators root —
then the fork-specific tail (altair+: sync committees; bellatrix+: genesis
execution payload header).

Ported from ethereum_consensus_tpu/models/genesis_common.py.
"""

from __future__ import annotations

from ..primitives import GENESIS_EPOCH
from .phase0.containers import BeaconBlockHeader, DepositData, Eth1Data, Fork

__all__ = [
    "initialize_state_generic",
    "IncrementalDepositRoot",
    "fold_genesis_deposits",
]


class IncrementalDepositRoot:
    """O(log n)-per-deposit ``List[DepositData, 2^32]`` prefix roots.

    The growing prefix-list root IS the EIP deposit contract's
    incremental tree (plus the SSZ length mix-in), so genesis never
    re-merkleizes the i-prefix per deposit — that was O(n² log n)
    hashing, the second-largest cost of large geneses."""

    DEPTH = 32  # log2 of the List[DepositData, 2^32] bound

    def __init__(self):
        import hashlib

        self._sha = hashlib.sha256
        self.branch = [b"\x00" * 32] * self.DEPTH
        self.count = 0

    def push(self, leaf: bytes) -> bytes:
        """Insert ``leaf``; returns the list root over all pushed leaves."""
        from ..ssz.merkle import zero_hash

        node = leaf
        size = self.count + 1
        for level in range(self.DEPTH):
            if size & 1:
                self.branch[level] = node
                break
            node = self._sha(self.branch[level] + node).digest()
            size >>= 1
        self.count += 1
        node = b"\x00" * 32
        size = self.count
        for level in range(self.DEPTH):
            if size & 1:
                node = self._sha(self.branch[level] + node).digest()
            else:
                node = self._sha(node + zero_hash(level)).digest()
            size >>= 1
        return self._sha(
            node + self.count.to_bytes(32, "little")
        ).digest()


def fold_genesis_deposits(state, deposits, context, process_deposit_fn) -> None:
    """The genesis deposit fold shared by every fork: batched
    deposit-signature verdicts (state-independent signing roots ⇒ one
    RLC multi-pairing for all deposits) + incremental deposit roots;
    per-deposit spec semantics unchanged."""
    from .phase0.block_processing import deposit_signature_verdicts

    verdicts = deposit_signature_verdicts(deposits, context)
    inc_root = IncrementalDepositRoot()
    for index, deposit in enumerate(deposits):
        state.eth1_data.deposit_root = inc_root.push(
            DepositData.hash_tree_root(deposit.data)
        )
        process_deposit_fn(
            state, deposit, context, signature_valid=verdicts[index]
        )


def initialize_state_generic(
    ns,
    fork_version: bytes,
    eth1_block_hash: bytes,
    eth1_timestamp: int,
    deposits: list,
    context,
    process_deposit_fn,
    get_next_sync_committee_fn=None,
    execution_payload_header=None,
):
    """Returns the fork's genesis BeaconState (see module docstring)."""
    state = ns.BeaconState(
        genesis_time=eth1_timestamp + context.genesis_delay,
        fork=Fork(
            previous_version=fork_version,
            current_version=fork_version,
            epoch=GENESIS_EPOCH,
        ),
        eth1_data=Eth1Data(block_hash=eth1_block_hash, deposit_count=len(deposits)),
        latest_block_header=BeaconBlockHeader(
            body_root=ns.BeaconBlockBody.hash_tree_root(ns.BeaconBlockBody())
        ),
        randao_mixes=[eth1_block_hash] * context.EPOCHS_PER_HISTORICAL_VECTOR,
    )

    fold_genesis_deposits(state, deposits, context, process_deposit_fn)

    for index, validator in enumerate(state.validators):
        balance = state.balances[index]
        validator.effective_balance = min(
            balance - balance % context.EFFECTIVE_BALANCE_INCREMENT,
            context.MAX_EFFECTIVE_BALANCE,
        )
        if validator.effective_balance == context.MAX_EFFECTIVE_BALANCE:
            validator.activation_eligibility_epoch = GENESIS_EPOCH
            validator.activation_epoch = GENESIS_EPOCH
    # direct current-epoch activation is unique to genesis: drop the
    # (future-epoch-mutation-invariant) active-set cache it violates
    state.__dict__.pop("_active_idx_cache", None)
    state.__dict__.pop("_total_active_balance_cache", None)

    state.genesis_validators_root = type(state).__ssz_fields__[
        "validators"
    ].hash_tree_root(state.validators)

    if get_next_sync_committee_fn is not None:
        sync_committee = get_next_sync_committee_fn(state, context)
        state.current_sync_committee = sync_committee
        state.next_sync_committee = sync_committee.copy()

    if execution_payload_header is not None:
        state.latest_execution_payload_header = execution_payload_header.copy()

    return state
