"""Epoch-boundary registry sweeps: the effective-balance hysteresis kernel
and the three altair sweeps (flag deltas, inactivity updates, inactivity
penalties), each with its plain version.

Reference parity: ethereum_consensus_tpu/ops/sweeps.py — the XLA programs
``_effective_balance_updates`` (:246, behind
``effective_balance_updates_device`` :265), ``_flag_deltas`` (:67, with
``_isqrt_u64`` :45, behind ``flag_deltas_device`` :117),
``_inactivity_updates`` (:147, behind ``inactivity_updates_device`` :165)
and ``_inactivity_penalties`` (:191, behind ``inactivity_penalties_device``
:202): the device twins of the literal epoch stages.

Words are unsigned 64-bit. At the tensor boundary they travel as int64
tensors holding the bit patterns (CPU torch has no arithmetic on uint64);
flags travel as bool tensors. Two paths per sweep with identical output on
the whole u64 range:
  - ``*_cuda``: the Hopper kernels in ``csrc/sweeps.cu`` and
    ``csrc/altair_sweeps.cu``;
  - ``*_plain``: int64 tensor ops that compare unsigned values with the
    sign bit flipped, add and multiply with wraparound (the same low 64
    bits as u64), and divide and take remainders unsigned (``_udiv``,
    ``_urem``).
Each dispatcher takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises. Every product wraps at 2^64 as
the reference's jnp.uint64 programs do: the literal route has no lane
guard.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import _kernels
from .registry_columns import pack_registry  # noqa: F401 — re-export

__all__ = [
    "effective_balance_updates",
    "effective_balance_updates_cuda",
    "effective_balance_updates_device",
    "effective_balance_updates_plain",
    "flag_deltas",
    "flag_deltas_cuda",
    "flag_deltas_device",
    "flag_deltas_plain",
    "hysteresis_scalars",
    "inactivity_penalties",
    "inactivity_penalties_cuda",
    "inactivity_penalties_device",
    "inactivity_penalties_plain",
    "inactivity_updates",
    "inactivity_updates_cuda",
    "inactivity_updates_device",
    "inactivity_updates_plain",
    "isqrt_u64",
    "launch_counts",
    "pack_registry",
]

# Kernel launches since the counts were last set to 0, one count per kernel:
# each ``_launch_*`` adds one to its own where it launches (the flag deltas'
# sum and element pass are one cooperative launch).
launch_counts = {
    "effective_balance": 0,
    "flag_deltas": 0,
    "inactivity_updates": 0,
    "inactivity_penalties": 0,
}

# partial sums of the flag-delta kernel: one a block of its cooperative
# launch, whose grid the launcher cuts to this many
FLAG_DELTAS_SCRATCH_WORDS = 4096

_MASK64 = (1 << 64) - 1
_SIGN = -(1 << 63)  # the sign bit as an int64 value
_LOW63 = (1 << 63) - 1


def hysteresis_scalars(context) -> tuple[int, int, int, int]:
    """(increment, max_effective, down, up) as unsigned 64-bit values,
    exactly the reference's ``jnp.uint64`` constants: the thresholds are
    (increment // quotient) * multiplier, wrapped to 64 bits."""
    increment = int(context.EFFECTIVE_BALANCE_INCREMENT)
    step = increment // int(context.HYSTERESIS_QUOTIENT)
    return (
        increment & _MASK64,
        int(context.MAX_EFFECTIVE_BALANCE) & _MASK64,
        step * int(context.HYSTERESIS_DOWNWARD_MULTIPLIER) & _MASK64,
        step * int(context.HYSTERESIS_UPWARD_MULTIPLIER) & _MASK64,
    )


def _check(balances: torch.Tensor, effective: torch.Tensor) -> None:
    if balances.dtype != torch.int64 or effective.dtype != torch.int64:
        raise TypeError(
            f"balances and effective balances must be int64 words, got "
            f"{balances.dtype}, {effective.dtype}"
        )
    if balances.dim() != 1 or balances.shape != effective.shape:
        raise ValueError(
            f"need two (n,) columns, got {tuple(balances.shape)}, {tuple(effective.shape)}"
        )
    if balances.device != effective.device:
        raise ValueError("balances and effective balances must be on one device")


def _as_int64(word: int) -> int:
    """The int64 value with the bit pattern of unsigned ``word``."""
    return word - (1 << 64) if word >> 63 else word


def _ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a < b on int64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _urem(x: torch.Tensor, d: int) -> torch.Tensor:
    """Unsigned x % d for 0 < d < 2^63: the remainder of the low 63 bits,
    plus 2^63 % d where the top bit is set, reduced without overflow."""
    low = torch.remainder(x & _LOW63, d)
    top = (x < 0).to(torch.int64) * ((1 << 63) % d)
    room = d - top  # >= 1; low + top >= d exactly when low >= room
    return torch.where(low >= room, low - room, low + top)


def effective_balance_updates_plain(balances: torch.Tensor, effective: torch.Tensor,
                                    context) -> torch.Tensor:
    """The new effective balance of every validator, in plain PyTorch:
    (n,) int64 words."""
    _check(balances, effective)
    return _hysteresis_plain(balances, effective, hysteresis_scalars(context))


def _hysteresis_plain(balances: torch.Tensor, effective: torch.Tensor,
                      scalars: tuple) -> torch.Tensor:
    """The hysteresis update of (n,) int64 words on the u64 scalars
    (increment, max_effective, down, up)."""
    increment, max_effective, down, up = scalars
    if not 0 < increment < 1 << 63:
        raise ValueError(f"the plain version needs 0 < increment < 2^63, got {increment}")
    update = _ult(balances + _as_int64(down), effective) | _ult(
        effective + _as_int64(up), balances
    )
    floor = balances - _urem(balances, increment)
    cap = _as_int64(max_effective)
    candidate = torch.where(_ult(floor, cap), floor, torch.full_like(floor, cap))
    return torch.where(update, candidate, effective)


def effective_balance_updates_cuda(balances: torch.Tensor, effective: torch.Tensor,
                                   context) -> torch.Tensor:
    """The new effective balance of every validator on the card
    (csrc/sweeps.cu)."""
    _check(balances, effective)
    if balances.device.type != "cuda":
        raise ValueError(f"effective_balance_updates_cuda needs CUDA tensors, got {balances.device}")
    if not (balances.is_contiguous() and effective.is_contiguous()):
        raise ValueError("balances and effective balances must be contiguous")
    increment, max_effective, down, up = hysteresis_scalars(context)
    if increment == 0:
        raise ValueError("EFFECTIVE_BALANCE_INCREMENT must be positive")
    return _launch(balances, effective, (increment, max_effective, down, up))


def _launch(balances: torch.Tensor, effective: torch.Tensor, scalars: tuple) -> torch.Tensor:
    """The launch alone, on inputs ``effective_balance_updates_cuda`` has
    checked (kernel timings call this directly)."""
    lib = _kernels.load("sweeps")
    out = torch.empty_like(balances)
    with torch.cuda.device(balances.device):
        stream = torch.cuda.current_stream(balances.device).cuda_stream
        rc = lib.effective_balance_launch(
            balances.data_ptr(), effective.data_ptr(), balances.shape[0],
            *scalars, out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"effective-balance kernel launch failed: CUDA error {rc}")
    launch_counts["effective_balance"] += 1
    return out


def effective_balance_updates(balances: torch.Tensor, effective: torch.Tensor,
                              context) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if balances.device.type == "cpu":
        return effective_balance_updates_plain(balances, effective, context)
    return effective_balance_updates_cuda(balances, effective, context)


def _words(column) -> torch.Tensor:
    """A uint64 numpy column as an int64 tensor of the same bits."""
    return torch.from_numpy(np.array(column, dtype=np.uint64).view(np.int64))


def effective_balance_updates_device(packed: dict, context, device="cuda") -> np.ndarray:
    """Device twin of phase0 process_effective_balance_updates: the
    ``balances`` and ``effective_balance`` uint64 columns of ``packed``
    (``pack_registry``) through the kernel on ``device`` (the plain version
    on ``"cpu"``); returns the new effective balances as a uint64 array."""
    balances = _words(packed["balances"]).to(device)
    effective = _words(packed["effective_balance"]).to(device)
    out = effective_balance_updates(balances, effective, context)
    return out.cpu().numpy().view(np.uint64)


# ---------------------------------------------------------------------------
# the altair sweeps: flag deltas, inactivity updates, inactivity penalties
# ---------------------------------------------------------------------------


def isqrt_u64(x: int) -> int:
    """The reference's ``_isqrt_u64`` (ops/sweeps.py:45) on one unsigned
    64-bit word, step for step in u64: a float64 seed plus one, six Newton
    steps each after a floor of one, then the two clamps. Its last clamp
    squares g + 1 in u64, which wraps near 2^64: at x = 2^64 - 1 the result
    is 2^32, one above ``math.isqrt``, as in the reference."""
    x &= _MASK64
    g = (int(math.sqrt(float(x))) + 1) & _MASK64
    for _ in range(6):
        g = max(g, 1)
        g = ((g + x // g) & _MASK64) >> 1
    if (g * g) & _MASK64 > x:
        g = (g - 1) & _MASK64
    if ((g + 1) * (g + 1)) & _MASK64 <= x:
        g = (g + 1) & _MASK64
    return g


def _udiv(x: torch.Tensor, d: int) -> torch.Tensor:
    """Unsigned x // d for a word d in [1, 2^64): the low 63 bits of x
    halved and divided, doubled, then one correction from the unsigned
    remainder (which lies in [0, 2d))."""
    if not 0 < d <= _MASK64:
        raise ValueError(f"unsigned division needs a divisor in [1, 2^64), got {d}")
    if d >> 63:
        return (~_ult(x, _as_int64(d))).to(torch.int64)
    q = (((x >> 1) & _LOW63) // d) << 1
    r = x - q * d
    return q + (~_ult(r, d)).to(torch.int64)


def _umin(x: torch.Tensor, word: int) -> torch.Tensor:
    """Unsigned min(x, word)."""
    w = _as_int64(word & _MASK64)
    return torch.where(_ult(x, w), x, torch.full_like(x, w))


def _usum(words: torch.Tensor) -> int:
    """The sum of unsigned words mod 2^64, exact: the low and high halves
    summed apart (each partial stays below 2^63 for fewer than 2^31
    words)."""
    lo = int((words & 0xFFFFFFFF).sum())
    hi = int(((words >> 32) & 0xFFFFFFFF).sum())
    return (lo + (hi << 32)) & _MASK64


def _check_columns(words: tuple, flags: tuple) -> None:
    """(n,) int64 word columns and (n,) bool flag columns, on one device."""
    columns = words + flags
    n = columns[0].shape
    for t in words:
        if t.dtype != torch.int64:
            raise TypeError(f"word columns must be int64, got {t.dtype}")
    for t in flags:
        if t.dtype != torch.bool:
            raise TypeError(f"flag columns must be bool, got {t.dtype}")
    for t in columns:
        if t.dim() != 1 or t.shape != n:
            raise ValueError(f"need (n,) columns of one length, got {[tuple(c.shape) for c in columns]}")
        if t.device != columns[0].device:
            raise ValueError("the columns must be on one device")


def _check_cuda(name: str, columns: tuple) -> None:
    if columns[0].device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {columns[0].device}")
    if not all(t.is_contiguous() for t in columns):
        raise ValueError(f"{name} needs contiguous columns")


def _flag_scalars(total_active: int, participating_sum: int, increment: int,
                  base_reward_factor: int, weight_denominator: int) -> tuple:
    """(brpi, unslashed_increments, reward_divisor) as the reference derives
    them (altair_core.h flag_scalars; the kernel's launcher makes the same
    from altair_core.h flag_sweep), in u64; raises on a zero divisor, which
    the launcher refuses too."""
    root = isqrt_u64(total_active)
    divisor = ((total_active // increment if increment else 0) * weight_denominator) & _MASK64
    if increment == 0 or weight_denominator == 0 or root == 0 or divisor == 0:
        raise ValueError(
            "flag deltas need a positive increment, weight denominator, total "
            f"active balance and reward divisor, got {increment}, "
            f"{weight_denominator}, {total_active}, {divisor}"
        )
    brpi = ((increment * base_reward_factor) & _MASK64) // root
    return brpi, participating_sum // increment, divisor


def flag_deltas_plain(eff, participating, eligible, total_active: int, weight: int,
                      increment: int, base_reward_factor: int,
                      weight_denominator: int, is_leaking: bool, is_head: bool):
    """One flag's (rewards, penalties) of every validator in plain PyTorch:
    (n,) int64 words each (the reference's ``_flag_deltas``)."""
    _check_columns((eff,), (participating, eligible))
    total_active, weight = total_active & _MASK64, weight & _MASK64
    brpi, increments, divisor = _flag_scalars(
        total_active, _usum(torch.where(participating, eff, 0)), increment,
        base_reward_factor, weight_denominator,
    )
    base_reward = _udiv(eff, increment) * _as_int64(brpi)
    numerator = base_reward * _as_int64(weight) * _as_int64(increments)
    zero = torch.zeros_like(eff)
    if is_leaking:
        rewards = zero
    else:
        rewards = torch.where(participating & eligible, _udiv(numerator, divisor), zero)
    if is_head:
        penalties = zero.clone()
    else:
        penalties = torch.where(
            eligible & ~participating,
            _udiv(base_reward * _as_int64(weight), weight_denominator), zero,
        )
    return rewards, penalties


def flag_deltas_cuda(eff, participating, eligible, total_active: int, weight: int,
                     increment: int, base_reward_factor: int,
                     weight_denominator: int, is_leaking: bool, is_head: bool):
    """One flag's (rewards, penalties) on the card (csrc/altair_sweeps.cu)."""
    columns = (eff, participating, eligible)
    _check_columns(columns[:1], columns[1:])
    _check_cuda("flag_deltas_cuda", columns)
    _flag_scalars(total_active & _MASK64, 0, increment, base_reward_factor,
                  weight_denominator)  # the launcher refuses the same inputs
    return _launch_flag_deltas(
        eff, participating, eligible,
        (total_active & _MASK64, weight & _MASK64, increment, base_reward_factor,
         weight_denominator, int(bool(is_leaking)), int(bool(is_head))),
    )


def _launch_flag_deltas(eff, participating, eligible, scalars: tuple):
    """The launch alone, on inputs ``flag_deltas_cuda`` has checked."""
    lib = _kernels.load("altair_sweeps")
    rewards = torch.empty_like(eff)
    penalties = torch.empty_like(eff)
    # a partial sum a block of the cooperative launch (its grid is cut to fit)
    scratch = torch.empty(FLAG_DELTAS_SCRATCH_WORDS, dtype=torch.int64, device=eff.device)
    with torch.cuda.device(eff.device):
        stream = torch.cuda.current_stream(eff.device).cuda_stream
        rc = lib.flag_deltas_launch(
            eff.data_ptr(), participating.data_ptr(), eligible.data_ptr(),
            eff.shape[0], *scalars, scratch.data_ptr(), FLAG_DELTAS_SCRATCH_WORDS,
            rewards.data_ptr(), penalties.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flag-deltas kernel launch failed: CUDA error {rc}")
    launch_counts["flag_deltas"] += 1
    return rewards, penalties


def flag_deltas(eff, participating, eligible, total_active: int, weight: int,
                increment: int, base_reward_factor: int, weight_denominator: int,
                is_leaking: bool, is_head: bool):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = flag_deltas_plain if eff.device.type == "cpu" else flag_deltas_cuda
    return fn(eff, participating, eligible, total_active, weight, increment,
              base_reward_factor, weight_denominator, is_leaking, is_head)


def inactivity_updates_plain(scores, participating, eligible, bias: int,
                             recovery_rate: int, is_leaking: bool):
    """Every validator's new inactivity score in plain PyTorch (the
    reference's ``_inactivity_updates``): (n,) int64 words."""
    _check_columns((scores,), (participating, eligible))
    decreased = scores - _umin(scores, 1)
    increased = scores + _as_int64(bias & _MASK64)
    out = torch.where(eligible, torch.where(participating, decreased, increased), scores)
    if not is_leaking:
        out = torch.where(eligible, out - _umin(out, recovery_rate), out)
    return out


def inactivity_updates_cuda(scores, participating, eligible, bias: int,
                            recovery_rate: int, is_leaking: bool):
    """Every validator's new inactivity score on the card
    (csrc/altair_sweeps.cu)."""
    columns = (scores, participating, eligible)
    _check_columns(columns[:1], columns[1:])
    _check_cuda("inactivity_updates_cuda", columns)
    return _launch_inactivity_updates(
        scores, participating, eligible,
        (bias & _MASK64, recovery_rate & _MASK64, int(bool(is_leaking))),
    )


def _launch_inactivity_updates(scores, participating, eligible, scalars: tuple):
    """The launch alone, on inputs ``inactivity_updates_cuda`` has checked."""
    lib = _kernels.load("altair_sweeps")
    out = torch.empty_like(scores)
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        rc = lib.inactivity_updates_launch(
            scores.data_ptr(), participating.data_ptr(), eligible.data_ptr(),
            scores.shape[0], *scalars, out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"inactivity-updates kernel launch failed: CUDA error {rc}")
    launch_counts["inactivity_updates"] += 1
    return out


def inactivity_updates(scores, participating, eligible, bias: int,
                       recovery_rate: int, is_leaking: bool):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = inactivity_updates_plain if scores.device.type == "cpu" else inactivity_updates_cuda
    return fn(scores, participating, eligible, bias, recovery_rate, is_leaking)


def _penalty_denominator(denominator: int) -> int:
    denominator &= _MASK64
    if denominator == 0:
        raise ValueError("the inactivity penalty denominator must not be 0 mod 2^64")
    return denominator


def inactivity_penalties_plain(eff, scores, not_target, denominator: int):
    """Every validator's inactivity penalty in plain PyTorch (the
    reference's ``_inactivity_penalties``; ``denominator`` is
    bias * quotient): (n,) int64 words."""
    _check_columns((eff, scores), (not_target,))
    denominator = _penalty_denominator(denominator)
    return torch.where(not_target, _udiv(eff * scores, denominator), torch.zeros_like(eff))


def inactivity_penalties_cuda(eff, scores, not_target, denominator: int):
    """Every validator's inactivity penalty on the card
    (csrc/altair_sweeps.cu)."""
    columns = (eff, scores, not_target)
    _check_columns(columns[:2], columns[2:])
    _check_cuda("inactivity_penalties_cuda", columns)
    return _launch_inactivity_penalties(eff, scores, not_target,
                                        _penalty_denominator(denominator))


def _launch_inactivity_penalties(eff, scores, not_target, denominator: int):
    """The launch alone, on inputs ``inactivity_penalties_cuda`` has
    checked."""
    lib = _kernels.load("altair_sweeps")
    out = torch.empty_like(eff)
    with torch.cuda.device(eff.device):
        stream = torch.cuda.current_stream(eff.device).cuda_stream
        rc = lib.inactivity_penalties_launch(
            eff.data_ptr(), scores.data_ptr(), not_target.data_ptr(), eff.shape[0],
            denominator, out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"inactivity-penalties kernel launch failed: CUDA error {rc}")
    launch_counts["inactivity_penalties"] += 1
    return out


def inactivity_penalties(eff, scores, not_target, denominator: int):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = inactivity_penalties_plain if eff.device.type == "cpu" else inactivity_penalties_cuda
    return fn(eff, scores, not_target, denominator)


def _flags(column) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(column, dtype=bool))


def _participating(packed: dict, flag_index: int) -> np.ndarray:
    return (
        ((packed["previous_participation"] >> np.uint8(flag_index)) & 1).astype(bool)
        & ~packed["slashed"]
        & packed["active_previous"]
    )


def _host(words: torch.Tensor) -> np.ndarray:
    return words.cpu().numpy().view(np.uint64)


def flag_deltas_device(packed: dict, flag_index: int, total_active_balance: int,
                       context, is_leaking: bool, device="cuda"):
    """Device twin of altair get_flag_index_deltas (helpers.rs:265) over the
    ``pack_registry`` columns, on ``device`` (the plain version on "cpu"):
    (rewards, penalties) as uint64 arrays."""
    from ..models.altair.constants import (
        PARTICIPATION_FLAG_WEIGHTS,
        TIMELY_HEAD_FLAG_INDEX,
        WEIGHT_DENOMINATOR,
    )

    rewards, penalties = flag_deltas(
        _words(packed["effective_balance"]).to(device),
        _flags(_participating(packed, flag_index)).to(device),
        _flags(packed["eligible"]).to(device),
        int(total_active_balance),
        int(PARTICIPATION_FLAG_WEIGHTS[flag_index]),
        int(context.EFFECTIVE_BALANCE_INCREMENT),
        int(context.BASE_REWARD_FACTOR),
        int(WEIGHT_DENOMINATOR),
        bool(is_leaking),
        flag_index == TIMELY_HEAD_FLAG_INDEX,
    )
    return _host(rewards), _host(penalties)


def inactivity_updates_device(packed: dict, context, is_leaking: bool, device="cuda"):
    """Device twin of altair process_inactivity_updates
    (epoch_processing.rs:104) on ``device``: the new scores as a uint64
    array."""
    from ..models.altair.constants import TIMELY_TARGET_FLAG_INDEX

    out = inactivity_updates(
        _words(packed["inactivity_scores"]).to(device),
        _flags(_participating(packed, TIMELY_TARGET_FLAG_INDEX)).to(device),
        _flags(packed["eligible"]).to(device),
        int(context.inactivity_score_bias),
        int(context.inactivity_score_recovery_rate),
        bool(is_leaking),
    )
    return _host(out)


def inactivity_penalties_device(packed: dict, context, quotient: int, device="cuda"):
    """Device twin of get_inactivity_penalty_deltas (per-fork quotient) on
    ``device``: the penalties as a uint64 array.

    The kernel multiplies effective_balance * score in u64, which wraps
    once a score exceeds 2^64 / effective_balance (~5.8e8 at 32 ETH) —
    scores that large need an inactivity leak lasting years, but they are
    representable, so, as in the reference, the spec's exact big-integer
    semantics are kept by an exact object-int path whenever the largest
    product could wrap."""
    from ..models.altair.constants import TIMELY_TARGET_FLAG_INDEX

    not_target = packed["eligible"] & ~_participating(packed, TIMELY_TARGET_FLAG_INDEX)
    eff = packed["effective_balance"]
    scores = packed["inactivity_scores"]
    denominator = int(context.inactivity_score_bias) * int(quotient)
    max_product = int(eff.max(initial=0)) * int(scores.max(initial=0))
    if max_product >= 1 << 64:
        products = eff.astype(object) * scores.astype(object)
        exact = np.where(not_target, products // denominator, 0)
        return exact.astype(np.uint64)
    out = inactivity_penalties(
        _words(eff).to(device), _words(scores).to(device),
        _flags(not_target).to(device), denominator,
    )
    return _host(out)
