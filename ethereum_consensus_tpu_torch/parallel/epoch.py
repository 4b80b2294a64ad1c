"""Mesh-sharded epoch sweeps: the altair epoch hot path over a device mesh.

The columnar epoch engine (models/epoch_vector.py) runs its per-validator
math over numpy columns. This module shards exactly those sweeps over the
mesh by validator row: each shard's rows go to its device, the masked
effective-balance sums that the rewards need are added across the shards
mod 2^64 (the reference's ``psum``, ``mesh.psum_words``), and the columns
come home bit-identical to the host kernels.

The kernels per shard: B5-altair's ``inactivity_updates``
(``ops/sweeps.py``) for the inactivity stage, and B3's two launches apart
(``ops/epoch.py``): ``fused_flag_sums`` on every shard, then
``fused_epoch_apply`` (or ``rewards_apply``, the rewards off the
post-update scores) on every shard with the summed words.

Padding discipline, as the reference's: the registry pads to a multiple of
the mesh size with neutral rows (zero words, all-False masks), which add
nothing to a sum, earn no delta and are cut off before the columns return.
The overflow contract survives sharding: the wrap census is summed across
the shards and a nonzero census returns ``None`` (the caller's staged host
path then raises the structured error).

Reference parity: ethereum_consensus_tpu/parallel/epoch.py (``pad_to_mesh``
:46, ``_inactivity_sharded`` :61, ``_fused_sharded`` :88,
``_rewards_sharded`` :132, ``MeshEpochSweeps`` :231).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import epoch as ops_epoch
from ..ops import sweeps
from .mesh import Mesh, psum_words

__all__ = ["MeshEpochSweeps", "pad_to_mesh"]


def pad_to_mesh(n: int, n_dev: int) -> int:
    """Smallest multiple of ``n_dev`` covering ``n`` rows — elementwise
    sweeps need no power-of-two subtrees (unlike the merkle shards), so a
    non-power-of-two registry pads by at most ``n_dev - 1`` neutral rows."""
    return -(-n // n_dev) * n_dev


def _host(words) -> np.ndarray:
    return words.cpu().numpy().view(np.uint64)


def _tensor(part: np.ndarray, device) -> torch.Tensor:
    """A numpy column on ``device``: u64 words as int64 bit patterns."""
    return torch.from_numpy(part.view(np.int64) if part.dtype == np.uint64 else part).to(device)


class MeshEpochSweeps:
    """Host-facing runner: pads, splits the rows over the shards, runs the
    kernels per shard, and joins and unpads — one instance per provisioned
    mesh (parallel/runtime.py). Every entry point is a drop-in for the host
    kernel it shadows and returns numpy (the epoch pass's column dtype)."""

    __slots__ = ("mesh", "n_dev")

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n_dev = mesh.n_dev

    def _shards(self, columns: tuple, dtypes: tuple) -> list:
        """Per shard, the rows of each column as tensors on its device (u64
        words as int64, bytes, bools), neutral rows padding the last."""
        n = columns[0].shape[0]
        rows = pad_to_mesh(n, self.n_dev) // self.n_dev
        out = []
        for i, device in enumerate(self.mesh.devices):
            lo, hi = i * rows, (i + 1) * rows
            shard = []
            for column, dtype in zip(columns, dtypes):
                part = np.zeros(rows, dtype=dtype)
                part[:max(0, min(hi, n) - lo)] = column[lo:hi]
                shard.append(_tensor(part, device))
            out.append(shard)
        return out

    def inactivity_scores(self, scores, eligible, participating, bias: int,
                          recovery_rate: int, leaking: bool):
        """Sharded ``process_inactivity_updates`` sweep; returns the new
        scores column (numpy uint64, original length)."""
        from . import runtime as _runtime

        n = scores.shape[0]
        _runtime.fault_point("epoch", stage="inactivity", validators=n, devices=self.n_dev)
        shards = self._shards((scores, participating, eligible), (np.uint64, bool, bool))
        outs = [sweeps.inactivity_updates(s, p, e, int(bias), int(recovery_rate), bool(leaking))
                for s, p, e in shards]
        return np.concatenate([_host(o) for o in outs])[:n]

    def _sums(self, shards) -> tuple:
        """The three flag sums of the whole registry: each shard's, then
        their psum."""
        return psum_words([ops_epoch.fused_flag_sums(eff, part, slashed, active)
                           for _, eff, part, slashed, active, _, _ in shards])

    def _columns(self, balances, eff, prev_part, slashed, active_prev, eligible, scores):
        return self._shards(
            (balances, eff, prev_part, slashed, active_prev, eligible, scores),
            (np.uint64, np.uint64, np.uint8, bool, bool, bool, np.uint64),
        )

    def fused(self, balances, eff, prev_part, slashed, active_prev,
              eligible, scores, increment: int, brpi: int,
              active_increments: int, denominator: int, bias: int,
              recovery_rate: int, weights: tuple, weight_denominator: int,
              leaking: bool, head_flag_index: int,
              target_flag_index: int) -> "tuple | None":
        """Inactivity + the full rewards stage, sharded: the flag sums per
        shard, their psum, then B3's element pass per shard. Returns
        ``(new_scores, new_balances)`` as numpy columns — or ``None`` when a
        u64 wrap surfaced (the caller falls back to the staged host path and
        its literal overflow mirror)."""
        from . import runtime as _runtime

        n = balances.shape[0]
        _runtime.fault_point("epoch", stage="fused", validators=n, devices=self.n_dev)
        shards = self._columns(balances, eff, prev_part, slashed, active_prev, eligible, scores)
        sums = self._sums(shards)
        outs = [ops_epoch.fused_epoch_apply(
            *shard, sums, int(increment), int(brpi), int(active_increments), int(denominator),
            int(bias), int(recovery_rate), tuple(int(w) for w in weights),
            int(weight_denominator), bool(leaking), int(head_flag_index),
            int(target_flag_index)) for shard in shards]
        if sum(wrapped for _, _, wrapped in outs):
            return None
        return (np.concatenate([_host(s) for s, _, _ in outs])[:n],
                np.concatenate([_host(b) for _, b, _ in outs])[:n])

    def rewards(self, balances, eff, prev_part, slashed, active_prev,
                eligible, scores, increment: int, brpi: int,
                active_increments: int, denominator: int, weights: tuple,
                weight_denominator: int, leaking: bool,
                head_flag_index: int, target_flag_index: int):
        """The full rewards stage off the post-update ``scores``, sharded;
        returns the new balances column — or ``None`` when a u64 wrap
        surfaced."""
        from . import runtime as _runtime

        n = balances.shape[0]
        _runtime.fault_point("epoch", stage="rewards", validators=n, devices=self.n_dev)
        shards = self._columns(balances, eff, prev_part, slashed, active_prev, eligible, scores)
        sums = self._sums(shards)
        outs = [ops_epoch.rewards_apply(
            *shard, sums, int(increment), int(brpi), int(active_increments), int(denominator),
            tuple(int(w) for w in weights), int(weight_denominator), bool(leaking),
            int(head_flag_index), int(target_flag_index)) for shard in shards]
        if sum(wrapped for _, wrapped in outs):
            return None
        return np.concatenate([_host(b) for b, _ in outs])[:n]
