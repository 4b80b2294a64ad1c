"""The shard kernels of the sharded chain step and of the sharded epoch sweep
step, and their plain versions.

Reference parity: ethereum_consensus_tpu/parallel/step.py, the per-shard
bodies of ``make_chain_step`` (:112-145) and ``_epoch_sweep_step``
(:294-383), whose collectives and merkle reduction ``parallel/step.py``
runs around these:

  - ``chain_step_shard``: one shard's hysteresis sweep, the sum of its
    active new effective balances, and its balance chunk words in the
    (8, n/4) layout of ``ops/merkle.py reduce_levels`` (the reference's
    ``u64_to_be_words(balances).reshape(n/4, 8).T``);
  - ``epoch_step_sums``: one shard's three flag sums over the unslashed
    validators active in the previous epoch and its active-current
    effective-balance total;
  - ``epoch_step_apply``: the element pass (inactivity update, three flag
    delta pairs, the inactivity penalty off the updated scores) on the summed
    words. The fused epoch kernel's element pass (``ops/epoch.py``) floors
    each flag sum at one increment, as the spec's get_total_balance does;
    the step does not (``psum(...) // increment``), so the two differ on a
    flag sum below one increment, and the step has its own.

Words travel as int64 tensors holding the u64 bit patterns, flags as bool
tensors, participation as uint8. Two paths with identical output on the
whole u64 range: the kernels of ``csrc/chain_step.cu`` for CUDA tensors,
the ``*_plain`` versions (int64 with explicit masks, the unsigned helpers of
``ops/sweeps.py``) for CPU tensors only; for CUDA tensors a wrapper launches
its kernel or raises. ``launch_counts`` counts each kernel's launches where
the wrapper launches it, and nowhere else.
"""

from __future__ import annotations

import torch

from .. import _kernels
from ..telemetry import device as _obs
from . import epoch as _epoch
from .sweeps import (
    _MASK64,
    _as_int64,
    _check_columns,
    _check_cuda,
    _hysteresis_plain,
    _usum,
    isqrt_u64,
)

__all__ = [
    "apply_args",
    "chain_step_shard",
    "chain_step_shard_cuda",
    "chain_step_shard_plain",
    "epoch_step_apply",
    "epoch_step_apply_cuda",
    "epoch_step_apply_plain",
    "epoch_step_scalars",
    "epoch_step_sums",
    "epoch_step_sums_cuda",
    "epoch_step_sums_plain",
    "launch_counts",
    "u64_to_be_words",
]

launch_counts = {"chain_step_shard": 0, "epoch_step_sums": 0, "epoch_step_apply": 0}

_PER_CHUNK = 4  # u64 balances in one 32-byte SSZ chunk


# ---------------------------------------------------------------------------
# the chain step's shard pass
# ---------------------------------------------------------------------------


def _check_chain(balances, effective, active, hysteresis: tuple) -> tuple:
    _check_columns((balances, effective), (active,))
    if balances.shape[0] % _PER_CHUNK:
        raise ValueError("per-device balance count must be a multiple of 4")
    if len(hysteresis) != 4:
        raise ValueError("hysteresis is (increment, max_effective, down, up)")
    words = tuple(int(v) & _MASK64 for v in hysteresis)
    if words[0] == 0:
        raise ValueError("the increment must be positive")
    return words


def _bswap32(x: torch.Tensor) -> torch.Tensor:
    """Byte swap of 32-bit values held in int64."""
    return (((x >> 24) & 0xFF) | ((x >> 8) & 0xFF00) | ((x << 8) & 0xFF0000)
            | ((x & 0xFF) << 24))


def u64_to_be_words(values: torch.Tensor) -> torch.Tensor:
    """(N,) int64 u64 words -> (2N,) int32: the big-endian-word view of the
    little-endian u64 byte serialization (SSZ basic-value packing; the
    reference's parallel/step.py:56)."""
    lo = _bswap32(values & 0xFFFFFFFF)
    hi = _bswap32((values >> 32) & 0xFFFFFFFF)
    words = torch.stack([lo, hi], dim=1).reshape(-1)
    return (words - ((words & 0x80000000) << 1)).to(torch.int32)


def chain_step_shard_plain(balances, effective, active, hysteresis: tuple):
    """One shard through the chain step in plain PyTorch: (new effective
    balances (n,) int64, balance chunk words (8, n/4) int32, the active
    new effective balances' sum as a (1,) int64 word)."""
    new_eff = _hysteresis_plain(balances, effective,
                                _check_chain(balances, effective, active, hysteresis))
    total = _usum(torch.where(active, new_eff, torch.zeros_like(new_eff)))
    words = u64_to_be_words(balances).reshape(-1, 8).T.contiguous()
    return (new_eff, words,
            torch.tensor([_as_int64(total)], dtype=torch.int64, device=balances.device))


def chain_step_shard_cuda(balances, effective, active, hysteresis: tuple):
    """``chain_step_shard_plain`` on the card (csrc/chain_step.cu); the sum
    stays on the card."""
    words = _check_chain(balances, effective, active, hysteresis)
    _check_cuda("chain_step_shard_cuda", (balances, effective, active))
    return _launch_chain(balances, effective, active, words)


def _launch_chain(balances, effective, active, words: tuple):
    """The launch alone, on checked inputs (kernel timings call this)."""
    lib = _kernels.load("chain_step")
    n = balances.shape[0]
    new_eff = torch.empty_like(balances)
    chunk_words = torch.empty((8, n // _PER_CHUNK), dtype=torch.int32, device=balances.device)
    total = torch.empty(1, dtype=torch.int64, device=balances.device)
    with torch.cuda.device(balances.device):
        stream = torch.cuda.current_stream(balances.device).cuda_stream
        rc = lib.chain_step_shard_launch(
            balances.data_ptr(), effective.data_ptr(), active.data_ptr(), n, *words,
            new_eff.data_ptr(), chunk_words.data_ptr(), total.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"chain step kernel launch failed: CUDA error {rc}")
    with _kernels.LAUNCH_LOCK:
        launch_counts["chain_step_shard"] += 1
    _obs.launch("chain_step_shard")
    return new_eff, chunk_words, total


def chain_step_shard(balances, effective, active, hysteresis: tuple):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = chain_step_shard_plain if balances.device.type == "cpu" else chain_step_shard_cuda
    return fn(balances, effective, active, hysteresis)


# ---------------------------------------------------------------------------
# the epoch step's sums
# ---------------------------------------------------------------------------


def _check_sums(eff, part, slashed, active_prev, active_cur) -> None:
    _check_columns((eff,), (slashed, active_prev, active_cur))
    if part.dtype != torch.uint8 or part.shape != eff.shape or part.device != eff.device:
        raise TypeError("participation must be an (n,) uint8 column beside the others")


def epoch_step_sums_plain(eff, part, slashed, active_prev, active_cur) -> torch.Tensor:
    """The four sums mod 2^64 as a (4,) int64 tensor of u64 bit patterns:
    the three flag sums, then the active-current total."""
    _check_sums(eff, part, slashed, active_prev, active_cur)
    zero = torch.zeros_like(eff)
    unslashed_active = active_prev & ~slashed
    sums = [_usum(torch.where(unslashed_active & ((part >> f) & 1).to(torch.bool), eff, zero))
            for f in range(3)]
    sums.append(_usum(torch.where(active_cur, eff, zero)))
    return torch.tensor([_as_int64(v) for v in sums], dtype=torch.int64, device=eff.device)


def epoch_step_sums_cuda(eff, part, slashed, active_prev, active_cur) -> torch.Tensor:
    """The four sums on the card (csrc/chain_step.cu: csrc/masked_sums.h's
    kernel at four sums); they stay there."""
    columns = (eff, part, slashed, active_prev, active_cur)
    _check_sums(*columns)
    _check_cuda("epoch_step_sums_cuda", columns)
    return _launch_sums(columns)


def _launch_sums(columns: tuple) -> torch.Tensor:
    """The launch alone, on checked inputs (kernel timings call this)."""
    sums = _epoch.launch_masked_sums("chain_step", "epoch_step_sums_launch", columns, 4)
    with _kernels.LAUNCH_LOCK:
        launch_counts["epoch_step_sums"] += 1
    _obs.launch("epoch_step_sums")
    return sums


def epoch_step_sums(eff, part, slashed, active_prev, active_cur) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = epoch_step_sums_plain if eff.device.type == "cpu" else epoch_step_sums_cuda
    return fn(eff, part, slashed, active_prev, active_cur)


# ---------------------------------------------------------------------------
# the epoch step's element pass
# ---------------------------------------------------------------------------


def epoch_step_scalars(sums, increment: int, base_reward_factor: int, bias: int,
                       recovery_rate: int, inactivity_quotient: int) -> dict:
    """The per-epoch scalars from the summed words (three flag sums, the
    active-current total; mod 2^64), as the reference's step body makes them
    (step.py:317-342, and csrc/chain_step_core.h epoch_step_scalars):
    ``total_active`` = max(total, increment), the base reward per increment
    off its isqrt (the reference's ``_isqrt``, step.py:283, is step for step
    ``ops/sweeps.py``'s, quirk near 2^64 included), the active increments,
    each flag's ``sum // increment`` with no floor, and the penalty
    denominator bias * quotient; all in wrapping u64."""
    if len(sums) != 4:
        raise ValueError(f"need the three flag sums and the active total, got {len(sums)}")
    sums = [int(v) & _MASK64 for v in sums]
    increment = int(increment) & _MASK64
    if increment == 0:
        raise ValueError("the increment must be positive")
    total_active = max(sums[3], increment)
    return {
        "total_active": total_active,
        "brpi": (increment * int(base_reward_factor) & _MASK64) // isqrt_u64(total_active),
        "active_increments": total_active // increment,
        "increments": [s // increment for s in sums[:3]],
        "denominator": int(bias) * int(inactivity_quotient) & _MASK64,
    }


def _apply_words(sums, increment, base_reward_factor, bias, recovery_rate,
                 inactivity_quotient, weights, weight_denominator, leaking,
                 head_flag_index, target_flag_index) -> tuple:
    """(the fused kernel's checked scalar words, each flag's increments)."""
    s = epoch_step_scalars(sums, increment, base_reward_factor, bias, recovery_rate,
                           inactivity_quotient)
    words = _epoch._scalars(increment, s["brpi"], s["active_increments"], s["denominator"],
                            bias, recovery_rate, weights, weight_denominator, leaking,
                            head_flag_index, target_flag_index)
    return words, s["increments"]


def epoch_step_apply_plain(balances, eff, part, slashed, active_prev, eligible, scores, sums,
                           increment: int, base_reward_factor: int, bias: int,
                           recovery_rate: int, inactivity_quotient: int, weights,
                           weight_denominator: int, leaking: bool, head_flag_index: int,
                           target_flag_index: int):
    """The element pass on the summed words in plain PyTorch: (new_balances,
    new_scores), (n,) int64 words."""
    _epoch._check_fused_columns(balances, eff, part, slashed, active_prev, eligible, scores)
    words, increments = _apply_words(sums, increment, base_reward_factor, bias, recovery_rate,
                                     inactivity_quotient, weights, weight_denominator, leaking,
                                     head_flag_index, target_flag_index)
    new_scores, new_balances, _ = _epoch._apply_plain(
        balances, eff, part, slashed, active_prev, eligible, scores, increments, words, True)
    return new_balances, new_scores


def epoch_step_apply_cuda(balances, eff, part, slashed, active_prev, eligible, scores, sums,
                          increment: int, base_reward_factor: int, bias: int,
                          recovery_rate: int, inactivity_quotient: int, weights,
                          weight_denominator: int, leaking: bool, head_flag_index: int,
                          target_flag_index: int):
    """The element pass on the card (csrc/chain_step.cu): the launcher makes
    the scalars from the same words."""
    columns = (balances, eff, part, slashed, active_prev, eligible, scores)
    _epoch._check_fused_columns(*columns)
    _check_cuda("epoch_step_apply_cuda", columns)
    return _launch_apply(columns, apply_args(
        sums, increment, base_reward_factor, bias, recovery_rate, inactivity_quotient, weights,
        weight_denominator, leaking, head_flag_index, target_flag_index))


def apply_args(sums, increment, base_reward_factor, bias, recovery_rate, inactivity_quotient,
               weights, weight_denominator, leaking, head_flag_index, target_flag_index) -> tuple:
    """The element-pass launcher's scalar arguments; raises where the plain
    version does (a zero divisor, a flag index outside 0..2)."""
    _apply_words(sums, increment, base_reward_factor, bias, recovery_rate, inactivity_quotient,
                 weights, weight_denominator, leaking, head_flag_index, target_flag_index)
    words = tuple(int(v) & _MASK64 for v in (
        *sums, increment, base_reward_factor, bias, recovery_rate, inactivity_quotient,
        *weights, weight_denominator))
    return words + (int(bool(leaking)), int(head_flag_index), int(target_flag_index))


def _launch_apply(columns: tuple, args: tuple):
    """The launch alone, on checked inputs and launcher arguments."""
    lib = _kernels.load("chain_step")
    balances = columns[0]
    new_scores = torch.empty_like(balances)
    new_balances = torch.empty_like(balances)
    with torch.cuda.device(balances.device):
        stream = torch.cuda.current_stream(balances.device).cuda_stream
        rc = lib.epoch_step_apply_launch(
            *(t.data_ptr() for t in columns), balances.shape[0], *args,
            new_scores.data_ptr(), new_balances.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"epoch step kernel launch failed: CUDA error {rc}")
    with _kernels.LAUNCH_LOCK:
        launch_counts["epoch_step_apply"] += 1
    _obs.launch("epoch_step_apply")
    return new_balances, new_scores


def epoch_step_apply(*args, **kwargs):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    balances = args[0] if args else kwargs["balances"]
    fn = epoch_step_apply_plain if balances.device.type == "cpu" else epoch_step_apply_cuda
    return fn(*args, **kwargs)
