"""capella spec helpers: withdrawal predicates.

Reference parity: ethereum-consensus/src/capella/helpers.rs —
has_eth1_withdrawal_credential, is_fully_withdrawable_validator,
is_partially_withdrawable_validator; everything else chains from bellatrix.
Ported from ethereum_consensus_tpu/models/capella/helpers.py.
"""

from __future__ import annotations

from ...primitives import ETH1_ADDRESS_WITHDRAWAL_PREFIX
from .. import _diff
from ..bellatrix import helpers as _bellatrix_helpers

__all__ = [
    "has_eth1_withdrawal_credential",
    "is_fully_withdrawable_validator",
    "is_partially_withdrawable_validator",
]


def has_eth1_withdrawal_credential(validator) -> bool:
    """(helpers.rs has_eth1_withdrawal_credential)"""
    return bytes(validator.withdrawal_credentials)[:1] == ETH1_ADDRESS_WITHDRAWAL_PREFIX


def is_fully_withdrawable_validator(validator, balance: int, epoch: int) -> bool:
    """(helpers.rs is_fully_withdrawable_validator)"""
    return (
        has_eth1_withdrawal_credential(validator)
        and validator.withdrawable_epoch <= epoch
        and balance > 0
    )


def is_partially_withdrawable_validator(validator, balance: int, context) -> bool:
    """(helpers.rs is_partially_withdrawable_validator)"""
    return (
        has_eth1_withdrawal_credential(validator)
        and validator.effective_balance == context.MAX_EFFECTIVE_BALANCE
        and balance > context.MAX_EFFECTIVE_BALANCE
    )


_diff.inherit(globals(), _bellatrix_helpers)
