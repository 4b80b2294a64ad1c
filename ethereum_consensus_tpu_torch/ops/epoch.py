"""The fused altair-family epoch kernel and its plain version.

Reference parity: ethereum_consensus_tpu/models/epoch_vector.py:297
``fused_epoch_kernel`` (jitted at :188), the one device dispatch of the
columnar engine's inactivity and rewards stages: the inactivity update,
three participation-flag delta pairs off masked effective-balance sums,
the inactivity penalty off the POST-update scores, and the four pairs
applied in sequence with zero saturation between them, with a census of
the adds that wrapped. Operation for operation the engine's staged host
kernels (``models/epoch_vector.py``), so the outputs are identical u64.

Words travel as int64 tensors holding the u64 bit patterns, flags as bool
tensors and the participation flags as uint8. Two paths with identical
output on the whole u64 range:
  - ``fused_epoch_cuda``: the Hopper kernel in ``csrc/fused_epoch.cu``;
  - ``fused_epoch_plain``: int64 tensor ops, with the unsigned helpers of
    ``ops/sweeps.py``.
``fused_epoch`` takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.

The reference's mesh twins (parallel/epoch.py :88 ``_fused_sharded``, the
same kernel with its sums wrapped in ``psum``, and :132
``_rewards_sharded``, the rewards alone off the post-update scores) need
the kernel's two halves apart: every shard's flag sums, added across the
shards mod 2^64, before any shard applies them. ``fused_flag_sums`` is the
first half alone (three words out), ``fused_epoch_apply`` the pass on
given sums, and ``rewards_apply`` that pass without the inactivity update;
each is one launch, has its plain version and its count in
``launch_counts``.

The reference's three staged programs (models/epoch_vector.py:234
``inactivity_scores_kernel``, :251 ``flag_deltas_kernel``, :285
``apply_delta_pairs_kernel``, jitted at :166-181 by ``jitted_kernels``)
are ``staged_inactivity_scores``, ``staged_flag_deltas`` and
``staged_apply_delta_pairs``: the kernels of ``csrc/epoch_staged.cu`` and
their plain versions, counted in ``launch_counts`` under their names. A
static scalar goes through ``numpy.uint64`` where the reference's does, so
an argument outside the u64 range raises the same ``OverflowError``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from ..telemetry import device as _obs
from .sweeps import _MASK64, _as_int64, _check_columns, _check_cuda, _udiv, _ult, _umin, _usum

__all__ = [
    "fused_epoch",
    "fused_epoch_apply",
    "fused_epoch_apply_cuda",
    "fused_epoch_apply_plain",
    "fused_epoch_cuda",
    "fused_epoch_device",
    "fused_epoch_plain",
    "fused_flag_sums",
    "fused_flag_sums_cuda",
    "fused_flag_sums_plain",
    "launch_count",
    "launch_counts",
    "rewards_apply",
    "rewards_apply_cuda",
    "rewards_apply_plain",
    "staged_apply_delta_pairs",
    "staged_apply_delta_pairs_cuda",
    "staged_apply_delta_pairs_plain",
    "staged_flag_deltas",
    "staged_flag_deltas_cuda",
    "staged_flag_deltas_plain",
    "staged_inactivity_scores",
    "staged_inactivity_scores_cuda",
    "staged_inactivity_scores_plain",
]

# Kernel launches since the count was last set to 0 (``_launch`` adds one
# per launch of the cooperative kernel, and nowhere else).
launch_count = 0
# The fused kernel's scratch: the three flag sums, the census, then three
# partial sums a block of its grid (the launcher cuts the grid to fit).
FUSED_SCRATCH_WORDS = 4 + 3 * 2048
# The split entries' launches, one count each, added where they launch.
launch_counts = {"fused_flag_sums": 0, "fused_epoch_apply": 0, "rewards_apply": 0,
                 "staged_inactivity_scores": 0, "staged_flag_deltas": 0,
                 "staged_apply_delta_pairs": 0}
# Blocks whose partial words a masked-sum call's tensor holds beside its
# output words (csrc/masked_sums.h; the launcher cuts the grid to fit).
MASKED_SUMS_BLOCKS = 2048


def _scalars(increment: int, brpi: int, active_increments: int, denominator: int,
             bias: int, recovery_rate: int, weights, weight_denominator: int,
             leaking: bool, head_flag_index: int, target_flag_index: int) -> tuple:
    """The kernel's scalar arguments as u64 words, in the launcher's order;
    raises on a zero divisor or a flag index outside 0..2, which the
    launcher refuses too."""
    if len(weights) != 3:
        raise ValueError(f"the fused epoch kernel needs three weights, got {len(weights)}")
    words = tuple(int(v) & _MASK64 for v in (
        increment, brpi, active_increments, denominator, bias, recovery_rate,
        *weights, weight_denominator,
    ))
    increment, _brpi, active_increments, denominator = words[:4]
    weight_denominator = words[9]
    divisor = (active_increments * weight_denominator) & _MASK64
    if 0 in (increment, weight_denominator, divisor, denominator):
        raise ValueError(
            "the fused epoch kernel needs a nonzero increment, weight "
            "denominator, reward divisor and penalty denominator"
        )
    if not (0 <= head_flag_index <= 2 and 0 <= target_flag_index <= 2):
        raise ValueError("flag indices must lie in 0..2")
    return words + (int(bool(leaking)), int(head_flag_index), int(target_flag_index))


def _check_fused_columns(balances, eff, prev_part, slashed, active_prev, eligible,
                         scores) -> None:
    _check_columns((balances, eff, scores), (slashed, active_prev, eligible))
    _check_flag_columns(eff, prev_part, slashed, active_prev)


def _check_flag_columns(eff, prev_part, slashed, active_prev) -> None:
    _check_columns((eff,), (slashed, active_prev))
    if (prev_part.dtype != torch.uint8 or prev_part.shape != eff.shape
            or prev_part.device != eff.device):
        raise TypeError("prev_part must be an (n,) uint8 column beside the others")


def _flag_sums(eff, prev_part, slashed, active_prev) -> list:
    """The three flag sums, each over the unslashed validators active in
    the previous epoch with the flag set, mod 2^64."""
    zero = torch.zeros_like(eff)
    unslashed_all = active_prev & ~slashed
    return [_usum(torch.where(unslashed_all & ((prev_part >> index) & 1).to(torch.bool), eff,
                              zero))
            for index in range(3)]


def _flag_increments(sums, increment: int) -> list:
    """Each flag's unslashed increments: get_total_balance floors the sum at
    one increment."""
    return [max(increment, int(s) & _MASK64) // increment for s in sums]


def _apply_plain(balances, eff, prev_part, slashed, active_prev, eligible, scores,
                 increments, words: tuple, update_scores: bool):
    """The element pass on each flag's unslashed ``increments``:
    (new_scores, new_balances, wrapped), the scores unchanged without
    ``update_scores``."""
    increment, brpi, active_increments, denominator, bias, recovery = words[:6]
    weights, weight_denominator, leaking = words[6:9], words[9], bool(words[10])
    head_flag_index, target_flag_index = words[11], words[12]
    divisor = (active_increments * weight_denominator) & _MASK64
    zero = torch.zeros_like(eff)
    unslashed_all = active_prev & ~slashed

    def flag(index: int) -> torch.Tensor:
        return unslashed_all & ((prev_part >> index) & 1).to(torch.bool)

    participating = flag(target_flag_index)
    new_scores = scores
    if update_scores:
        # process_inactivity_updates (spec order: before the reward deltas)
        new_scores = torch.where(eligible & participating, scores - _umin(scores, 1), scores)
        new_scores = torch.where(eligible & ~participating, new_scores + _as_int64(bias),
                                 new_scores)
        if not leaking:
            new_scores = torch.where(eligible, new_scores - _umin(new_scores, recovery),
                                     new_scores)

    base_reward = _udiv(eff, increment) * _as_int64(brpi)
    pairs = []
    for index, weight in enumerate(weights):
        unslashed = flag(index)
        w = _as_int64(weight)
        if leaking:
            rewards = zero
        else:
            rewards = torch.where(
                eligible & unslashed,
                _udiv(base_reward * w * _as_int64(increments[index]), divisor), zero,
            )
        if index == head_flag_index:
            penalties = zero
        else:
            penalties = torch.where(
                eligible & ~unslashed, _udiv(base_reward * w, weight_denominator), zero,
            )
        pairs.append((rewards, penalties))
    # inactivity penalties off the POST-update scores (spec order)
    missed = eligible & ~participating
    pairs.append((zero, torch.where(missed, _udiv(eff * new_scores, denominator), zero)))

    # apply in spec sequence with zero saturation BETWEEN pairs, counting
    # the adds that wrapped
    wrapped = 0
    new_balances = balances
    for rewards, penalties in pairs:
        raised = new_balances + rewards
        wrapped += int(_ult(raised, new_balances).sum())
        new_balances = torch.where(~_ult(raised, penalties), raised - penalties, zero)
    return new_scores, new_balances, wrapped


def fused_epoch_plain(balances, eff, prev_part, slashed, active_prev, eligible, scores,
                      increment: int, brpi: int, active_increments: int,
                      denominator: int, bias: int, recovery_rate: int, weights,
                      weight_denominator: int, leaking: bool, head_flag_index: int,
                      target_flag_index: int):
    """(new_scores, new_balances, wrapped) in plain PyTorch: two (n,) int64
    word columns and the wrap census as an int."""
    _check_fused_columns(balances, eff, prev_part, slashed, active_prev, eligible, scores)
    words = _scalars(increment, brpi, active_increments, denominator, bias,
                     recovery_rate, weights, weight_denominator, leaking,
                     head_flag_index, target_flag_index)
    increments = _flag_increments(_flag_sums(eff, prev_part, slashed, active_prev), words[0])
    return _apply_plain(balances, eff, prev_part, slashed, active_prev, eligible, scores,
                        increments, words, True)


def fused_epoch_cuda(balances, eff, prev_part, slashed, active_prev, eligible, scores,
                     increment: int, brpi: int, active_increments: int,
                     denominator: int, bias: int, recovery_rate: int, weights,
                     weight_denominator: int, leaking: bool, head_flag_index: int,
                     target_flag_index: int):
    """(new_scores, new_balances, wrapped) on the card
    (csrc/fused_epoch.cu); reading the census waits for the kernel."""
    columns = (balances, eff, prev_part, slashed, active_prev, eligible, scores)
    _check_fused_columns(balances, eff, prev_part, slashed, active_prev, eligible, scores)
    _check_cuda("fused_epoch_cuda", columns)
    words = _scalars(increment, brpi, active_increments, denominator, bias,
                     recovery_rate, weights, weight_denominator, leaking,
                     head_flag_index, target_flag_index)
    new_scores, new_balances, scratch = _launch(columns, words)
    return new_scores, new_balances, int(scratch[3])


def _launch(columns: tuple, words: tuple):
    """The launch alone, on inputs ``fused_epoch_cuda`` has checked; returns
    (new_scores, new_balances, scratch), scratch[0..3] holding the three flag
    sums and the wrap census."""
    global launch_count
    lib = _kernels.load("fused_epoch")
    balances = columns[0]
    new_scores = torch.empty_like(balances)
    new_balances = torch.empty_like(balances)
    scratch = torch.empty(FUSED_SCRATCH_WORDS, dtype=torch.int64, device=balances.device)
    with torch.cuda.device(balances.device):
        stream = torch.cuda.current_stream(balances.device).cuda_stream
        rc = lib.fused_epoch_launch(
            *(t.data_ptr() for t in columns), balances.shape[0], *words,
            scratch.data_ptr(), FUSED_SCRATCH_WORDS, new_scores.data_ptr(),
            new_balances.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused epoch kernel launch failed: CUDA error {rc}")
    with _kernels.LAUNCH_LOCK:
        launch_count += 1
    _obs.launch("fused_epoch")
    return new_scores, new_balances, scratch


def fused_epoch(*args, **kwargs):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    balances = args[0] if args else kwargs["balances"]
    fn = fused_epoch_plain if balances.device.type == "cpu" else fused_epoch_cuda
    return fn(*args, **kwargs)


# ---------------------------------------------------------------------------
# The two launches apart, for the mesh twins (parallel/epoch.py)
# ---------------------------------------------------------------------------


def _sum_words(sums) -> list:
    if len(sums) != 3:
        raise ValueError(f"need the three flag sums, got {len(sums)}")
    return [int(v) & _MASK64 for v in sums]


def fused_flag_sums_plain(eff, prev_part, slashed, active_prev) -> torch.Tensor:
    """The three flag sums mod 2^64, as a (3,) int64 tensor of u64 bit
    patterns on the columns' device."""
    _check_flag_columns(eff, prev_part, slashed, active_prev)
    sums = _flag_sums(eff, prev_part, slashed, active_prev)
    return torch.tensor([_as_int64(v) for v in sums], dtype=torch.int64, device=eff.device)


def fused_flag_sums_cuda(eff, prev_part, slashed, active_prev) -> torch.Tensor:
    """The flag sums on the card (csrc/fused_epoch.cu: csrc/masked_sums.h's
    kernel at three sums); the (3,) result stays on the card."""
    columns = (eff, prev_part, slashed, active_prev)
    _check_flag_columns(*columns)
    _check_cuda("fused_flag_sums_cuda", columns)
    sums = launch_masked_sums("fused_epoch", "fused_flag_sums_launch", columns, 3)
    with _kernels.LAUNCH_LOCK:
        launch_counts["fused_flag_sums"] += 1
    _obs.launch("fused_flag_sums")
    return sums


def launch_masked_sums(library: str, fn_name: str, columns: tuple, k: int) -> torch.Tensor:
    """One launch of csrc/masked_sums.h's kernel through ``fn_name`` of
    ``library`` on checked CUDA columns (the effective balances first): the
    k output words and the blocks' partial words in one tensor, each word of
    which the kernel writes before it reads it (nothing is zeroed); returns
    the view of the k words. Counting is the caller's."""
    lib = _kernels.load(library)
    eff = columns[0]
    words = torch.empty(k * (1 + MASKED_SUMS_BLOCKS), dtype=torch.int64, device=eff.device)
    with torch.cuda.device(eff.device):
        stream = torch.cuda.current_stream(eff.device).cuda_stream
        rc = getattr(lib, fn_name)(*(t.data_ptr() for t in columns), eff.shape[0],
                                   words.data_ptr(), words.shape[0], stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: masked sums kernel launch failed: CUDA error {rc}")
    return words[:k]


def fused_flag_sums(eff, prev_part, slashed, active_prev) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = fused_flag_sums_plain if eff.device.type == "cpu" else fused_flag_sums_cuda
    return fn(eff, prev_part, slashed, active_prev)


def fused_epoch_apply_plain(balances, eff, prev_part, slashed, active_prev, eligible, scores,
                            sums, increment: int, brpi: int, active_increments: int,
                            denominator: int, bias: int, recovery_rate: int, weights,
                            weight_denominator: int, leaking: bool, head_flag_index: int,
                            target_flag_index: int):
    """``fused_epoch_plain`` on given flag sums (three u64 words):
    (new_scores, new_balances, wrapped)."""
    _check_fused_columns(balances, eff, prev_part, slashed, active_prev, eligible, scores)
    words = _scalars(increment, brpi, active_increments, denominator, bias,
                     recovery_rate, weights, weight_denominator, leaking,
                     head_flag_index, target_flag_index)
    return _apply_plain(balances, eff, prev_part, slashed, active_prev, eligible, scores,
                        _flag_increments(_sum_words(sums), words[0]), words, True)


def _launch_apply(fn_name: str, count: str, columns: tuple, sums: list, words: tuple,
                  census: torch.Tensor, out_scores: bool):
    """Launch ``fn_name`` (the element pass) on checked inputs, the three
    flag sums as u64 words (the launcher makes the increments) and a device
    word for the census (zeroed by the launcher); returns (new_scores or
    None, new_balances)."""
    lib = _kernels.load("fused_epoch")
    balances = columns[0]
    new_scores = torch.empty_like(balances) if out_scores else None
    new_balances = torch.empty_like(balances)
    outs = ((new_scores,) if out_scores else ()) + (new_balances,)
    with torch.cuda.device(balances.device):
        stream = torch.cuda.current_stream(balances.device).cuda_stream
        rc = getattr(lib, fn_name)(
            *(t.data_ptr() for t in columns), balances.shape[0], *_sum_words(sums), *words,
            census.data_ptr(), *(t.data_ptr() for t in outs), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{count} kernel launch failed: CUDA error {rc}")
    with _kernels.LAUNCH_LOCK:
        launch_counts[count] += 1
    _obs.launch(count)
    return new_scores, new_balances


def fused_epoch_apply_cuda(balances, eff, prev_part, slashed, active_prev, eligible, scores,
                           sums, increment: int, brpi: int, active_increments: int,
                           denominator: int, bias: int, recovery_rate: int, weights,
                           weight_denominator: int, leaking: bool, head_flag_index: int,
                           target_flag_index: int):
    """The fused kernel's element pass on given sums, on the card;
    reading the census waits for the kernel."""
    columns = (balances, eff, prev_part, slashed, active_prev, eligible, scores)
    _check_fused_columns(*columns)
    _check_cuda("fused_epoch_apply_cuda", columns)
    words = _scalars(increment, brpi, active_increments, denominator, bias,
                     recovery_rate, weights, weight_denominator, leaking,
                     head_flag_index, target_flag_index)
    census = torch.empty(1, dtype=torch.int64, device=balances.device)
    new_scores, new_balances = _launch_apply("fused_epoch_apply_launch", "fused_epoch_apply",
                                             columns, sums, words, census, True)
    return new_scores, new_balances, int(census[0])


def fused_epoch_apply(*args, **kwargs):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    balances = args[0] if args else kwargs["balances"]
    fn = fused_epoch_apply_plain if balances.device.type == "cpu" else fused_epoch_apply_cuda
    return fn(*args, **kwargs)


def rewards_apply_plain(balances, eff, prev_part, slashed, active_prev, eligible, scores, sums,
                        increment: int, brpi: int, active_increments: int, denominator: int,
                        weights, weight_denominator: int, leaking: bool,
                        head_flag_index: int, target_flag_index: int):
    """The rewards and penalties off ``scores`` (the post-update scores) on
    given flag sums, without the inactivity update: (new_balances,
    wrapped)."""
    _check_fused_columns(balances, eff, prev_part, slashed, active_prev, eligible, scores)
    words = _scalars(increment, brpi, active_increments, denominator, 0, 0, weights,
                     weight_denominator, leaking, head_flag_index, target_flag_index)
    _, new_balances, wrapped = _apply_plain(balances, eff, prev_part, slashed, active_prev,
                                            eligible, scores,
                                            _flag_increments(_sum_words(sums), words[0]), words,
                                            False)
    return new_balances, wrapped


def rewards_apply_cuda(balances, eff, prev_part, slashed, active_prev, eligible, scores, sums,
                       increment: int, brpi: int, active_increments: int, denominator: int,
                       weights, weight_denominator: int, leaking: bool,
                       head_flag_index: int, target_flag_index: int):
    """The rewards lane on given sums, on the card (csrc/fused_epoch.cu);
    reading the census waits for the kernel."""
    columns = (balances, eff, prev_part, slashed, active_prev, eligible, scores)
    _check_fused_columns(*columns)
    _check_cuda("rewards_apply_cuda", columns)
    words = _scalars(increment, brpi, active_increments, denominator, 0, 0, weights,
                     weight_denominator, leaking, head_flag_index, target_flag_index)
    # the launcher takes no bias or recovery rate: the lane updates no score
    words = words[:4] + words[6:]
    census = torch.empty(1, dtype=torch.int64, device=balances.device)
    _, new_balances = _launch_apply("rewards_apply_launch", "rewards_apply", columns, sums,
                                    words, census, False)
    return new_balances, int(census[0])


def rewards_apply(*args, **kwargs):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    balances = args[0] if args else kwargs["balances"]
    fn = rewards_apply_plain if balances.device.type == "cpu" else rewards_apply_cuda
    return fn(*args, **kwargs)


def fused_epoch_device(balances, eff, prev_part, slashed, active_prev, eligible, scores,
                       increment: int, brpi: int, active_increments: int,
                       denominator: int, bias: int, recovery_rate: int, weights,
                       weight_denominator: int, leaking: bool, head_flag_index: int,
                       target_flag_index: int, device="cuda"):
    """The columnar engine's entry: numpy columns (uint64, uint8 and bool)
    in, one upload; (new_scores, new_balances) as uint64 arrays and the
    wrap census as an int out. On ``device`` (the plain version on
    "cpu")."""
    tensors = _obs.h2d(
        "epoch_vector.fused",
        np.asarray(balances, np.uint64), np.asarray(eff, np.uint64),
        np.asarray(prev_part, np.uint8), np.asarray(slashed, bool),
        np.asarray(active_prev, bool), np.asarray(eligible, bool),
        np.asarray(scores, np.uint64), device=device,
    )
    new_scores, new_balances, wrapped = fused_epoch(
        *tensors, increment, brpi, active_increments, denominator, bias,
        recovery_rate, weights, weight_denominator, leaking, head_flag_index,
        target_flag_index,
    )
    return (_obs.d2h("epoch_vector.fused", new_scores, np.uint64),
            _obs.d2h("epoch_vector.fused", new_balances, np.uint64), wrapped)


# ---------------------------------------------------------------------------
# The three staged programs (csrc/epoch_staged.cu)
# ---------------------------------------------------------------------------


def _u64(value) -> int:
    """``numpy.uint64(value)`` as an int: the reference's static-scalar
    conversion, raising ``OverflowError`` outside [0, 2^64) as it does."""
    return int(np.uint64(value))


def _inactivity_words(bias, recovery_rate, leaking: bool) -> tuple:
    """(bias, recovery_rate) as the reference converts them: the recovery
    rate only outside a leak (0 inside, where it is not read)."""
    return _u64(bias), 0 if leaking else _u64(recovery_rate)


def staged_inactivity_scores_plain(scores, eligible, participating, bias, recovery_rate,
                                   leaking: bool) -> torch.Tensor:
    """The reference's inactivity_scores_kernel in plain PyTorch: (n,)
    int64 words of the new scores."""
    _check_columns((scores,), (eligible, participating))
    bias, recovery = _inactivity_words(bias, recovery_rate, leaking)
    hit = eligible & participating
    miss = eligible & ~participating
    new = torch.where(hit, scores - _umin(scores, 1), scores)
    new = torch.where(miss, new + _as_int64(bias), new)
    if not leaking:
        new = torch.where(eligible, new - _umin(new, recovery), new)
    return new


def staged_inactivity_scores_cuda(scores, eligible, participating, bias, recovery_rate,
                                  leaking: bool) -> torch.Tensor:
    """The new scores on the card (csrc/epoch_staged.cu)."""
    columns = (scores, eligible, participating)
    _check_columns((scores,), (eligible, participating))
    _check_cuda("staged_inactivity_scores_cuda", columns)
    bias, recovery = _inactivity_words(bias, recovery_rate, leaking)
    out = torch.empty_like(scores)
    lib = _kernels.load("epoch_staged")
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        rc = lib.staged_inactivity_launch(
            scores.data_ptr(), eligible.data_ptr(), participating.data_ptr(), scores.shape[0],
            bias, recovery, int(bool(leaking)), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"staged inactivity kernel launch failed: CUDA error {rc}")
    with _kernels.LAUNCH_LOCK:
        launch_counts["staged_inactivity_scores"] += 1
    _obs.launch("staged_inactivity_scores")
    return out


def staged_inactivity_scores(scores, *args, **kwargs) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = (staged_inactivity_scores_plain if scores.device.type == "cpu"
          else staged_inactivity_scores_cuda)
    return fn(scores, *args, **kwargs)


def _flag_words(weight, unslashed_increments, active_increments, weight_denominator,
                leaking: bool, is_head_flag: bool) -> tuple:
    """(weight, unslashed_increments, reward_divisor, weight_denominator)
    as u64 words, converted where and as the reference converts them: the
    reward branch's three outside a leak (the divisor the exact product
    active_increments * weight_denominator), the penalty branch's two off
    the head flag; a word a branch does not read is 0."""
    weight_word = increments = divisor = denominator = 0
    if not leaking:
        weight_word = _u64(weight)
        increments = _u64(unslashed_increments)
        divisor = _u64(active_increments * weight_denominator)
    if not is_head_flag:
        weight_word = _u64(weight)
        denominator = _u64(weight_denominator)
    return weight_word, increments, divisor, denominator


def staged_flag_deltas_plain(base_reward, eligible, unslashed, weight, unslashed_increments,
                             active_increments, weight_denominator, leaking: bool,
                             is_head_flag: bool):
    """The reference's flag_deltas_kernel in plain PyTorch: (rewards,
    penalties), two (n,) int64 word columns. A zero divisor gives zero
    quotients, as numpy's integer division does."""
    _check_columns((base_reward,), (eligible, unslashed))
    w, increments, divisor, denominator = _flag_words(
        weight, unslashed_increments, active_increments, weight_denominator, leaking,
        is_head_flag)
    zero = torch.zeros_like(base_reward)
    rewards = zero
    if not leaking and divisor:
        numerator = base_reward * _as_int64(w) * _as_int64(increments)
        rewards = torch.where(eligible & unslashed, _udiv(numerator, divisor), zero)
    penalties = zero
    if not is_head_flag and denominator:
        penalties = torch.where(eligible & ~unslashed,
                                _udiv(base_reward * _as_int64(w), denominator), zero)
    return rewards, penalties


def staged_flag_deltas_cuda(base_reward, eligible, unslashed, weight, unslashed_increments,
                            active_increments, weight_denominator, leaking: bool,
                            is_head_flag: bool):
    """One flag's (rewards, penalties) on the card (csrc/epoch_staged.cu)."""
    columns = (base_reward, eligible, unslashed)
    _check_columns((base_reward,), (eligible, unslashed))
    _check_cuda("staged_flag_deltas_cuda", columns)
    words = _flag_words(weight, unslashed_increments, active_increments, weight_denominator,
                        leaking, is_head_flag)
    rewards = torch.empty_like(base_reward)
    penalties = torch.empty_like(base_reward)
    lib = _kernels.load("epoch_staged")
    with torch.cuda.device(base_reward.device):
        stream = torch.cuda.current_stream(base_reward.device).cuda_stream
        rc = lib.staged_flag_deltas_launch(
            *(t.data_ptr() for t in columns), base_reward.shape[0], *words,
            int(bool(leaking)), int(bool(is_head_flag)), rewards.data_ptr(),
            penalties.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"staged flag deltas kernel launch failed: CUDA error {rc}")
    with _kernels.LAUNCH_LOCK:
        launch_counts["staged_flag_deltas"] += 1
    _obs.launch("staged_flag_deltas")
    return rewards, penalties


def staged_flag_deltas(base_reward, *args, **kwargs):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = staged_flag_deltas_plain if base_reward.device.type == "cpu" else staged_flag_deltas_cuda
    return fn(base_reward, *args, **kwargs)


def _check_pairs(balances, rewards, penalties) -> None:
    _check_columns((balances,), ())
    for t in (rewards, penalties):
        if t.dtype != torch.int64 or t.dim() != 2 or t.shape[1] != balances.shape[0]:
            raise ValueError(
                f"the pairs must be (k, n) int64 words, got {tuple(t.shape)} {t.dtype}"
            )
        if t.device != balances.device:
            raise ValueError("the columns must be on one device")
    if rewards.shape != penalties.shape:
        raise ValueError("rewards and penalties must have one shape")


def staged_apply_delta_pairs_plain(balances, rewards, penalties) -> torch.Tensor:
    """The reference's apply_delta_pairs_kernel in plain PyTorch, the k
    pairs as (k, n) rewards and penalties: (n,) int64 words."""
    _check_pairs(balances, rewards, penalties)
    zero = torch.zeros_like(balances)
    for reward, penalty in zip(rewards, penalties):
        raised = balances + reward
        balances = torch.where(_ult(raised, penalty), zero, raised - penalty)
    return balances


def staged_apply_delta_pairs_cuda(balances, rewards, penalties) -> torch.Tensor:
    """The pairs applied on the card (csrc/epoch_staged.cu), one pass."""
    _check_pairs(balances, rewards, penalties)
    _check_cuda("staged_apply_delta_pairs_cuda", (balances, rewards, penalties))
    out = torch.empty_like(balances)
    lib = _kernels.load("epoch_staged")
    with torch.cuda.device(balances.device):
        stream = torch.cuda.current_stream(balances.device).cuda_stream
        rc = lib.staged_apply_pairs_launch(
            balances.data_ptr(), rewards.data_ptr(), penalties.data_ptr(), balances.shape[0],
            rewards.shape[0], out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"staged apply kernel launch failed: CUDA error {rc}")
    with _kernels.LAUNCH_LOCK:
        launch_counts["staged_apply_delta_pairs"] += 1
    _obs.launch("staged_apply_delta_pairs")
    return out


def staged_apply_delta_pairs(balances, rewards, penalties) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = (staged_apply_delta_pairs_plain if balances.device.type == "cpu"
          else staged_apply_delta_pairs_cuda)
    return fn(balances, rewards, penalties)
