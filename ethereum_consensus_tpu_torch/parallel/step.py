"""The distributed chain step: one epoch-boundary device sweep, sharded.

The validator registry is sharded row-wise over the mesh, and one step
performs on the devices:

  1. the effective-balance hysteresis sweep (phase0
     process_effective_balance_updates);
  2. the total-active-balance reduction (the reference's ``psum``);
  3. the SSZ ``hash_tree_root`` of the balances list: each shard's subtree
     on its own device, the shards' roots gathered on the mesh's first
     device (the reference's ``all_gather``), the top tree from their level
     and the length mix-in, bit-identical to the host merkleizer.

Per shard, one launch of ``ops/chain_step.py``'s shard kernel (K1, the
sweep, the sum and the chunk words in B2's layout), then B2
(``ops/merkle.py reduce_levels``); on the first device B2 from the shards'
level, and B1 (``ops/sha256.py``) for the one mix-in message. The epoch
sweep step runs K2 (``epoch_step_sums``) per shard, adds the sums across
the shards mod 2^64 (``mesh.psum_words``), makes the per-epoch scalars on
the host, and runs K3 (``epoch_step_apply``) per shard.

Each step takes whole (N,) columns (numpy, or tensors on any device),
splits them over ``mesh.devices`` in contiguous row ranges, and returns its
columns gathered on ``mesh.devices[0]``: u64 words as int64 tensors, the
root as an (8,) int32 tensor, the totals as ints.

Reference parity: ethereum_consensus_tpu/parallel/step.py
(``u64_to_be_words`` :56, ``_length_words`` :64, ``make_chain_step`` :75,
``pad_registry_for_mesh`` :164, ``run_chain_step`` :174,
``make_epoch_sweep_step`` :201, ``_epoch_sweep_step`` :254). The port's mesh
is one-dimensional, so the factories take no ``axis_name``; the reference's
``RuntimeError`` without ``jax_enable_x64`` has no counterpart (torch's
int64 words always carry exact u64 bit patterns). Where the reference's
outputs stay replicated on every device, the port's are on the first.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.chain_step import (
    chain_step_shard,
    epoch_step_apply,
    epoch_step_scalars,
    epoch_step_sums,
    u64_to_be_words,
)
from ..ops.merkle import reduce_levels
from ..ops.sha256 import sha256_64b
from ..ssz.merkle import next_pow_of_two
from .mesh import Mesh, all_gather, psum_words

__all__ = [
    "make_chain_step",
    "make_epoch_sweep_step",
    "pad_registry_for_mesh",
    "run_chain_step",
    "u64_to_be_words",
]

_MASK64 = (1 << 64) - 1
_SIGN = -(1 << 63)


def _length_words(length: int) -> np.ndarray:
    """(8,) uint32 word view of the SSZ length mix-in chunk."""
    chunk = length.to_bytes(8, "little") + b"\x00" * 24
    return np.frombuffer(chunk, dtype=">u4").astype(np.uint32)


def _column(values, kind: str) -> torch.Tensor:
    """A column as a tensor where it lies (numpy goes to the host): u64
    words as int64 bit patterns, "u8" as uint8, "bool" as bool."""
    if torch.is_tensor(values):
        return values.view(torch.int64) if values.dtype == torch.uint64 else values
    dtype = {"u64": np.uint64, "u8": np.uint8, "bool": np.bool_}[kind]
    arr = np.array(values, dtype=dtype)  # a writable copy
    return torch.from_numpy(arr.view(np.int64) if kind == "u64" else arr)


def _words32(words) -> torch.Tensor:
    """(8,) u32 words (numpy or a tensor) as an int32 tensor."""
    if torch.is_tensor(words):
        return words.to(torch.int32)
    return torch.from_numpy(np.array(words, dtype=np.uint32).view(np.int32))


def _shards(column: torch.Tensor, mesh: Mesh) -> list:
    """Shard i: the i-th contiguous range of N / n_dev rows on
    ``mesh.devices[i]``."""
    n, n_dev = column.shape[0], mesh.n_dev
    if n % n_dev:
        raise ValueError(f"registry length {n} not divisible by mesh size {n_dev}")
    local = n // n_dev
    return [column[i * local:(i + 1) * local].to(device).contiguous()
            for i, device in enumerate(mesh.devices)]


def _gather(parts, mesh: Mesh) -> torch.Tensor:
    return torch.cat([p.to(mesh.devices[0]) for p in parts])


def _umax(words: torch.Tensor) -> int:
    """The largest unsigned word of an int64 column."""
    return (int((words ^ _SIGN).max()) ^ _SIGN) & _MASK64


@functools.lru_cache(maxsize=8)
def make_chain_step(
    mesh: Mesh,
    registry_limit: int = 2**40,
    effective_balance_increment: int = 10**9,
    max_effective_balance: int = 32 * 10**9,
    hysteresis_quotient: int = 4,
    hysteresis_downward_multiplier: int = 1,
    hysteresis_upward_multiplier: int = 5,
):
    """Build the distributed chain step over ``mesh``.

    Returns ``step(balances, effective_balances, active_mask, zero_words,
    length_words)``: three (N,) columns with N divisible by the mesh size and
    N / n_dev a power-of-two multiple of 4 (one SSZ chunk packs four u64
    balances; ``run_chain_step`` takes any size), ``zero_words`` the (64, 8)
    int32 table of ``ops.merkle.zero_hash_words`` and ``length_words`` the
    (8,) word view of the SSZ length mix-in chunk (``_length_words``).
    Returns ``(new_effective_balances, total_active_balance, balances_root)``:
    the (N,) int64 words and the (8,) int32 root words on the mesh's first
    device, the total as an int. Raises ``ValueError`` for a shard whose
    balance count is not a multiple of 4 or whose chunk count is not a
    power of two, as the reference's body does."""
    chunk_limit = (registry_limit + 3) // 4
    depth = (next_pow_of_two(chunk_limit) - 1).bit_length()
    step_size = effective_balance_increment // hysteresis_quotient
    hysteresis = tuple(v & _MASK64 for v in (
        effective_balance_increment, max_effective_balance,
        step_size * hysteresis_downward_multiplier, step_size * hysteresis_upward_multiplier))

    def step(balances, effective_balances, active_mask, zero_words, length_words):
        bal = _column(balances, "u64")
        eff = _column(effective_balances, "u64")
        act = _column(active_mask, "bool")
        shards = list(zip(_shards(bal, mesh), _shards(eff, mesh), _shards(act, mesh)))
        local_n = shards[0][0].shape[0]
        if local_n % 4:
            raise ValueError("per-device balance count must be a multiple of 4")
        # each device must own a full, aligned 2^k-chunk subtree
        local_chunks = local_n // 4
        if local_chunks == 0 or local_chunks & (local_chunks - 1):
            raise ValueError(f"per-device chunk count {local_chunks} must be a power of two")
        local_depth = (local_chunks - 1).bit_length()
        first = mesh.devices[0]
        outs = []
        for b, e, a in shards:
            new_eff, words, total = chain_step_shard(b, e, a, hysteresis)
            outs.append((new_eff, total, reduce_levels(words, zero_words.to(b.device),
                                                       local_depth)))
        (total,) = psum_words([t for _, t, _ in outs])
        roots = all_gather([r for _, _, r in outs], mesh).T.contiguous()
        merkle = reduce_levels(roots, zero_words.to(first), depth, start_level=local_depth)
        msg = torch.cat([merkle, _words32(length_words).to(first)]).reshape(16, 1)
        root = sha256_64b(msg)[:, 0]
        return _gather([e for e, _, _ in outs], mesh), total, root

    return step


def pad_registry_for_mesh(n: int, n_dev: int) -> int:
    """Padded registry length for an arbitrary ``n`` on an ``n_dev`` mesh:
    each device owns an aligned power-of-two subtree of whole SSZ chunks
    (4 u64 per chunk). Zero padding is the merkleizer's own padding, so
    roots are unchanged as long as the TRUE length feeds the mix-in."""
    per_dev_chunks = next_pow_of_two(max(1, -(-n // (4 * n_dev))))
    return n_dev * per_dev_chunks * 4


def _u64_array(values) -> np.ndarray:
    if torch.is_tensor(values):
        return values.cpu().numpy().view(np.uint64)
    return np.asarray(values, dtype=np.uint64)


def run_chain_step(step, mesh: Mesh, balances, effective, active, zero_words):
    """``make_chain_step``'s step for ANY registry size: zero-pads the
    columns to the mesh-aligned width (inactive padding adds nothing to the
    total, and zero chunks are the merkleizer's own padding), runs the step
    with the true length in the mix-in, and cuts the padded tail off.
    Returns (new effective balances as uint64 numpy, the total as an int,
    the (8,) uint32 root words as numpy)."""
    n = len(balances)
    padded = pad_registry_for_mesh(n, mesh.n_dev)
    bal = np.zeros(padded, np.uint64)
    bal[:n] = _u64_array(balances)
    eff = np.zeros(padded, np.uint64)
    eff[:n] = _u64_array(effective)
    act = np.zeros(padded, np.bool_)
    act[:n] = active.cpu().numpy() if torch.is_tensor(active) else active
    new_eff, total, root_words = step(bal, eff, act, zero_words, _length_words(n))
    return (new_eff.cpu().numpy().view(np.uint64)[:n], int(total),
            root_words.cpu().numpy().view(np.uint32))


def make_epoch_sweep_step(mesh: Mesh, context, is_leaking: bool = False,
                          check_score_bound: bool = True):
    """The distributed altair epoch sweep: inactivity-score updates, the
    three participation-flag delta sweeps, inactivity penalties and balance
    application, sharded row-wise over the mesh with totals summed across
    the shards, matching the reference's step bit for bit (saturating
    decreases and application order included).

    Returns ``step(balances, effective, participation, slashed,
    active_previous, active_current, eligible, scores)`` over (N,) columns
    (N divisible by the mesh size) -> ``(new_balances, new_scores,
    total_active_balance)``: int64 words on the mesh's first device and an
    int. ``participation`` is the uint8 flag byte of the delta epoch.

    Precondition of the bit-identical guarantee: every
    ``effective_balance * inactivity_score`` product fits in u64. By
    default the step checks ``max(effective) * max(scores)`` first and
    raises ``OverflowError`` above 2^64 (that epoch must take the host spec
    path); ``check_score_bound=False`` gives the unchecked step, whose
    products wrap as the reference's do.

    The context is unhashable, so this wrapper takes the five scalars the
    sweep uses and defers to the cached factory."""
    return _epoch_sweep_step(
        mesh,
        int(context.EFFECTIVE_BALANCE_INCREMENT),
        int(context.BASE_REWARD_FACTOR),
        int(context.inactivity_score_bias),
        int(context.inactivity_score_recovery_rate),
        int(context.INACTIVITY_PENALTY_QUOTIENT_ALTAIR),
        is_leaking,
        check_score_bound,
    )


@functools.lru_cache(maxsize=16)
def _epoch_sweep_step(
    mesh: Mesh,
    effective_balance_increment: int,
    base_reward_factor: int,
    inactivity_score_bias: int,
    inactivity_score_recovery_rate: int,
    inactivity_penalty_quotient: int,
    is_leaking: bool,
    check_score_bound: bool,
):
    from ..models.altair.constants import (
        PARTICIPATION_FLAG_WEIGHTS,
        TIMELY_HEAD_FLAG_INDEX,
        TIMELY_TARGET_FLAG_INDEX,
        WEIGHT_DENOMINATOR,
    )

    constants = (effective_balance_increment, base_reward_factor, inactivity_score_bias,
                 inactivity_score_recovery_rate, inactivity_penalty_quotient)
    flags = (tuple(PARTICIPATION_FLAG_WEIGHTS), WEIGHT_DENOMINATOR, bool(is_leaking),
             TIMELY_HEAD_FLAG_INDEX, TIMELY_TARGET_FLAG_INDEX)

    def step(balances, eff, participation, slashed, active_prev, active_cur, eligible,
             scores):
        columns = [_column(c, kind) for c, kind in zip(
            (balances, eff, participation, slashed, active_prev, active_cur, eligible, scores),
            ("u64", "u64", "u8", "bool", "bool", "bool", "bool", "u64"))]
        shards = list(zip(*(_shards(c, mesh) for c in columns)))
        sums = psum_words([epoch_step_sums(e, p, s, ap, ac)
                           for _, e, p, s, ap, ac, _, _ in shards])
        total_active = epoch_step_scalars(sums, *constants)["total_active"]
        outs = [epoch_step_apply(b, e, p, s, ap, el, sc, sums, *constants, *flags)
                for b, e, p, s, ap, _, el, sc in shards]
        return (_gather([b for b, _ in outs], mesh), _gather([s for _, s in outs], mesh),
                total_active)

    if not check_score_bound:
        return step

    def checked_step(balances, eff, participation, slashed, active_prev, active_cur,
                     eligible, scores):
        max_product = _umax(_column(eff, "u64")) * _umax(_column(scores, "u64"))
        if max_product >= 1 << 64:
            raise OverflowError(
                "inactivity score × effective balance exceeds uint64: the device epoch "
                "sweep would wrap; route this epoch through the host spec path (see "
                "make_epoch_sweep_step)"
            )
        return step(balances, eff, participation, slashed, active_prev, active_cur,
                    eligible, scores)

    return checked_step
