"""Structured error taxonomy for the state-transition function.

Reference parity: ethereum-consensus/src/error.rs (Error, InvalidBlock,
InvalidOperation and per-operation invalidity enums, error.rs:15-275).

In Python these are exception classes: spec functions raise the most specific
subtype; callers (the Executor, the conformance harness) catch
``StateTransitionError`` to observe "transition must fail" vectors.
"""

from __future__ import annotations


class Error(Exception):
    """Root of the library's error hierarchy (error.rs:15)."""


class DeserializationError(Error):
    pass


class SerializationError(Error):
    pass


class MerkleizationError(Error):
    pass


class OverflowError_(Error):
    """u64 arithmetic overflow (error.rs:41-44)."""


class UnderflowError(Error):
    """u64 arithmetic underflow."""


class OutOfBoundsError(Error):
    """Index out of bounds for a bounded collection."""


class CollectionError(Error):
    """Bounded collection over/underflow (push beyond limit)."""


class UnknownForkError(Error):
    def __init__(self, version_or_slot):
        super().__init__(f"unknown fork for {version_or_slot!r}")


class IncompatibleForksError(Error):
    def __init__(self, block_fork, state_fork):
        super().__init__(
            f"block fork {block_fork} incompatible with state fork {state_fork}"
        )
        self.block_fork = block_fork
        self.state_fork = state_fork


class CryptoError(Error):
    pass


class InvalidSignatureError(CryptoError):
    pass


class InvalidPublicKeyError(CryptoError):
    pass


class InvalidSecretKeyError(CryptoError):
    pass


class KzgError(CryptoError):
    pass


class StateTransitionError(Error):
    """Any failure of the state-transition function (invalid block/operation).
    error.rs:69+ (InvalidBlock and below)."""


class InvalidBlock(StateTransitionError):
    pass


class InvalidBeaconBlockHeader(InvalidBlock):
    pass


class InvalidStateRoot(InvalidBlock):
    def __init__(self, expected: bytes, got: bytes):
        super().__init__(
            f"state root mismatch: block {expected.hex()} != computed {got.hex()}"
        )


class InvalidOperation(InvalidBlock):
    pass


class InvalidAttestation(InvalidOperation):
    pass


class InvalidIndexedAttestation(InvalidOperation):
    pass


class InvalidDeposit(InvalidOperation):
    pass


class InvalidRandao(InvalidOperation):
    pass


class InvalidProposerSlashing(InvalidOperation):
    pass


class InvalidAttesterSlashing(InvalidOperation):
    pass


class InvalidVoluntaryExit(InvalidOperation):
    pass


class InvalidSyncAggregate(InvalidOperation):
    pass


class InvalidExecutionPayload(InvalidOperation):
    pass


class InvalidWithdrawals(InvalidOperation):
    pass


class InvalidBlsToExecutionChange(InvalidOperation):
    pass


class InvalidDepositRequest(InvalidOperation):
    pass


class InvalidWithdrawalRequest(InvalidOperation):
    pass


class InvalidConsolidation(InvalidOperation):
    pass


class InvalidBlobData(InvalidOperation):
    pass


class ExecutionEngineError(StateTransitionError):
    """The (mock) execution engine rejected a payload
    (execution_engine.rs:20 failure path)."""


# -- checked u64 arithmetic helpers -----------------------------------------

U64_MAX = 2**64 - 1


def checked_add(a: int, b: int) -> int:
    c = a + b
    if c > U64_MAX:
        raise OverflowError_(f"u64 overflow: {a} + {b}")
    return c


def checked_sub(a: int, b: int) -> int:
    if b > a:
        raise UnderflowError(f"u64 underflow: {a} - {b}")
    return a - b


def checked_mul(a: int, b: int) -> int:
    c = a * b
    if c > U64_MAX:
        raise OverflowError_(f"u64 overflow: {a} * {b}")
    return c


def saturating_add(a: int, b: int) -> int:
    return min(a + b, U64_MAX)


def saturating_sub(a: int, b: int) -> int:
    return max(a - b, 0)
