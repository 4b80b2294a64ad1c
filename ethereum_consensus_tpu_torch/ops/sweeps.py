"""Epoch-boundary registry sweeps: the effective-balance hysteresis kernel
and its plain version.

Reference parity: ethereum_consensus_tpu/ops/sweeps.py:246
``_effective_balance_updates`` (the XLA program behind
``effective_balance_updates_device``, :265), the device twin of phase0
``process_effective_balance_updates``. The altair-family sweeps of that
module (flag deltas, inactivity) are not ported yet.

Words are unsigned 64-bit. At the tensor boundary they travel as int64
tensors holding the bit patterns (CPU torch has no arithmetic on uint64).
Two paths with identical output on the whole u64 range:
  - ``effective_balance_updates_cuda``: the Hopper kernel in
    ``csrc/sweeps.cu``;
  - ``effective_balance_updates_plain``: int64 tensor ops that compare
    unsigned values with the sign bit flipped, add with wraparound and
    take the unsigned remainder in two halves.
``effective_balance_updates`` takes the plain version for CPU tensors only;
for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from .registry_columns import pack_registry  # noqa: F401 — re-export

__all__ = [
    "effective_balance_updates",
    "effective_balance_updates_cuda",
    "effective_balance_updates_device",
    "effective_balance_updates_plain",
    "hysteresis_scalars",
    "launch_count",
    "pack_registry",
]

# Kernel launches since the count was last set to 0 (``_launch`` adds one
# per launch and nowhere else).
launch_count = 0

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
    increment, max_effective, down, up = hysteresis_scalars(context)
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
    global launch_count
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
    launch_count += 1
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
