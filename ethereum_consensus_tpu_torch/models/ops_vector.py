"""Columnar registry helpers — cached registry columns, their
write-direction commits, and the block-scoped attestation fast path of the
altair family.

* ``RegistryColumns`` — numpy column views over a state's registry
  (validator scalar fields + the scalar lists), built once warm and
  **delta-invalidated through the SSZ mutation instrumentation**: every
  sanctioned write channel (``CachedRootList`` instrumented mutators,
  ``Container.__setattr__``'s weak-parent notify, ``bulk_store``'s
  changed-indices contract) marks the list's ``_col_dirty`` element set,
  and the cache refreshes exactly those rows on next access. Anything
  untrackable resets the channel and the cache rebuilds — stale reads are
  structurally impossible, the cost model degrades, never the values.
* ``process_attestations_batch`` — the block-scoped altair attestation
  fast path: per attestation the full spec validation runs through the
  SAME ``_prepare_attestation`` the scalar path uses, but the
  participation-flag writes land in working numpy arrays and commit ONCE
  per participation list via ``bulk_store`` with exact changed indices.
  Bit-identical to the scalar loop (the fallback and the differential
  oracle), including mid-block failure: an invalid attestation commits
  the earlier attestations' flags before re-raising.

* ``pack_registry_cached`` feeds the epoch sweeps from the cache instead
  of per-call ``np.fromiter`` walks; ``effective_balance_update_hits``
  vectorizes the hysteresis sweep; ``adopt_list_column`` is the columnar
  epoch engine's commit (models/epoch_vector.py) and
  ``install_zero_column`` its participation rotation;
  ``withdrawal_columns`` feeds capella's withdrawals sweep
  (``models/capella/block_processing.py``).

Contract for every array this module hands out: READ-ONLY views
(``writeable=False``); consumers copy before mutating.

Reference parity: ethereum_consensus_tpu/models/ops_vector.py. Left out
with the forks that need them: the electra compounding cap of
``effective_balance_update_hits``, and the serving plane's
``registry_snapshot`` / ``gather_rows``. The memory-observatory and trace
seams are cut (telemetry slice). Every decline counts in
``ops_vector.fallback.{reason}``.
"""

from __future__ import annotations

import threading

from .. import _env
from ..ssz.core import CachedRootList, bulk_store
from ..telemetry import metrics

__all__ = [
    "RegistryColumns",
    "adopt_list_column",
    "columns_for",
    "effective_balance_update_hits",
    "fallback",
    "withdrawal_columns",
    "install_zero_column",
    "pack_registry_cached",
    "process_attestations_batch",
    "register_attestation_preparer",
    "BATCH_MIN_VALIDATORS",
    "BATCH_MIN_ATTESTATIONS",
]

# Below this registry size the scalar loops win (column extraction and
# working-array copies cost more than ~n dict/flag operations); the
# differential tests lower it to 0 to force the engine on tiny states.
BATCH_MIN_VALIDATORS = 1 << 10
BATCH_MIN_ATTESTATIONS = 1

_DISABLE_ENV = "ECT_OPS_VECTOR"  # =off disables every columnar path


def _np():
    try:
        import numpy

        return numpy
    except Exception:  # noqa: BLE001 — environment without numpy
        return None


def fallback(reason: str) -> None:
    """Record a degradation to a scalar path (counter per occurrence)."""
    metrics.counter(f"ops_vector.fallback.{reason}").inc()


def _disabled() -> bool:
    return _env.flag_off(_DISABLE_ENV)


# ---------------------------------------------------------------------------
# registry columns
# ---------------------------------------------------------------------------


_VAL_INT_FIELDS = (
    "effective_balance",
    "activation_epoch",
    "activation_eligibility_epoch",
    "exit_epoch",
    "withdrawable_epoch",
)


def _read_validator_row(v):
    """(ints..., slashed, prefix) for one validator, or None when a field
    holds a type the column contract can't trust (mutable buffer)."""
    creds = v.withdrawal_credentials
    if type(creds) is not bytes or len(creds) == 0:
        return None
    try:
        ints = tuple(int(getattr(v, f)) for f in _VAL_INT_FIELDS)
    except (TypeError, ValueError):
        return None
    for x in ints:
        if x < 0 or x >= 1 << 64:
            return None
    return ints, bool(v.slashed), creds[0]


# _col_cache records, stored ON the CachedRootList itself so they travel
# across state copies (ssz/core.py _share_col_cache — structural share,
# copy-on-write via _col_owned): ("validators", arrays_dict) for the
# registry, ("list", arr, vmax) for scalar lists.


def _build_validator_cols(vals) -> "dict | None":
    np = _np()
    if np is None or vals.__class__ is not CachedRootList:
        return None
    n = len(vals)
    try:
        # the credentials type scan is the purity guard: a bytes value is
        # immutable, so every later change MUST flow through __setattr__
        # (which marks _col_dirty); a bytearray could mutate in place
        if not all(
            type(v.withdrawal_credentials) is bytes
            and len(v.withdrawal_credentials) >= 1
            for v in vals
        ):
            return None
        arrays = {
            f: np.fromiter((getattr(v, f) for v in vals), np.uint64, n)
            for f in _VAL_INT_FIELDS
        }
        arrays["slashed"] = np.fromiter(
            (bool(v.slashed) for v in vals), np.bool_, n
        )
        arrays["withdrawal_prefix"] = np.fromiter(
            (v.withdrawal_credentials[0] for v in vals), np.uint8, n
        )
    except (TypeError, ValueError, OverflowError):
        return None
    # arm the element-dirty channel only when the weak-parent wiring is
    # installed (every element notifies the list on __setattr__); without
    # it a field write would be invisible — no cache, rebuild per access
    if not vals._parents_registered:
        metrics.counter("ops_vector.columns.untracked_builds").inc()
        return arrays
    vals._col_cache = ("validators", arrays)
    vals._col_owned = True
    vals._col_dirty = set()
    metrics.counter("ops_vector.columns.builds").inc()
    return arrays


def _sync_validator_cols(vals) -> "dict | None":
    cc = vals._col_cache
    cd = vals._col_dirty
    if (
        cc is None
        or cd is None
        or cc[0] != "validators"
        or next(iter(cc[1].values())).shape[0] != len(vals)
    ):
        return _build_validator_cols(vals)
    arrays = cc[1]
    if cd:
        if not vals._col_owned:
            # shared with a copy sibling: clone before the first refresh
            arrays = {k: a.copy() for k, a in arrays.items()}
            vals._col_cache = ("validators", arrays)
            vals._col_owned = True
        for i in cd:
            row = _read_validator_row(list.__getitem__(vals, i))
            if row is None:
                vals._col_dirty = None
                return _build_validator_cols(vals)
            ints, sl, px = row
            for f, x in zip(_VAL_INT_FIELDS, ints):
                arrays[f][i] = x
            arrays["slashed"][i] = sl
            arrays["withdrawal_prefix"][i] = px
        metrics.counter("ops_vector.columns.refresh_rows").inc(len(cd))
        cd.clear()
    return arrays


def _build_list_col(src, dtype, vmax):
    np = _np()
    if np is None or src.__class__ is not CachedRootList:
        return None
    try:
        wide = np.array(src, dtype=np.uint64)
    except (TypeError, ValueError, OverflowError):
        return None
    if wide.ndim != 1 or wide.shape[0] != len(src):
        return None
    if vmax < (1 << 64) - 1 and bool((wide > vmax).any()):
        return None
    arr = wide.astype(dtype) if dtype is not np.uint64 else wide
    src._col_cache = ("list", arr, vmax)
    src._col_owned = True
    src._col_dirty = set()
    metrics.counter("ops_vector.columns.builds").inc()
    return arr


def _sync_list_col(src, dtype, vmax):
    cc = src._col_cache
    cd = src._col_dirty
    if (
        cc is None
        or cd is None
        or cc[0] != "list"
        or cc[2] != vmax
        or cc[1].shape[0] != len(src)
        or cc[1].dtype != dtype
    ):
        return _build_list_col(src, dtype, vmax)
    arr = cc[1]
    if cd:
        if not src._col_owned:
            arr = arr.copy()
            src._col_cache = ("list", arr, vmax)
            src._col_owned = True
        for i in cd:
            v = list.__getitem__(src, i)
            if type(v) is not int or v < 0 or v > vmax:
                src._col_dirty = None
                return _build_list_col(src, dtype, vmax)
            arr[i] = v
        metrics.counter("ops_vector.columns.refresh_rows").inc(len(cd))
        cd.clear()
    return arr


def _readonly(arr):
    view = arr.view()
    view.flags.writeable = False
    return view


class RegistryColumns:
    """Thin per-state accessor over the list-resident column caches.

    The caches live on the ``CachedRootList`` objects themselves
    (``_col_cache``/``_col_owned``/``_col_dirty``, ssz/core.py), so they
    travel across ``state.copy()`` structurally (copy-on-write). This
    object only resolves fields and applies the dtype contract."""

    # scalar-list fields this cache serves, with their column value cap
    LIST_FIELDS = {
        "balances": (1 << 64) - 1,
        "inactivity_scores": (1 << 64) - 1,
        "previous_epoch_participation": 0xFF,
        "current_epoch_participation": 0xFF,
    }

    __slots__ = ("_state",)

    def __init__(self, state):
        self._state = state

    def validator_columns(self, state=None) -> "dict | None":
        """Read-only validator field columns, or None (no numpy / exotic
        values — callers fall back to their scalar loop)."""
        vals = (state or self._state).validators
        arrays = _sync_validator_cols(vals)
        if arrays is None:
            return None
        return {k: _readonly(a) for k, a in arrays.items()}

    def list_column(self, state, field: str):
        """Read-only uint column over ``state.<field>`` or None."""
        np = _np()
        if np is None:
            return None
        vmax = self.LIST_FIELDS[field]
        dtype = np.dtype(np.uint8) if vmax == 0xFF else np.dtype(np.uint64)
        src = getattr(state, field, None)
        if src is None or src.__class__ is not CachedRootList:
            return None
        arr = _sync_list_col(src, dtype, vmax)
        if arr is None:
            return None
        return _readonly(arr)


def columns_for(state) -> "RegistryColumns | None":
    """Column accessor for ``state`` (None when disabled / no numpy)."""
    if _disabled() or _np() is None:
        return None
    return RegistryColumns(state)


def pack_registry_cached(state, previous_epoch: int,
                         use_current_participation: bool = False) -> dict:
    """Cache-backed twin of ``ops.registry_columns.pack_registry`` — the
    same dict shape and the same ``activity_masks`` eligibility formula,
    fed from the delta-refreshed columns instead of per-call fromiter
    walks. Falls back to the literal packing when columns are
    unavailable."""
    cols = columns_for(state)
    packed = None
    if cols is not None:
        packed = _pack_from_columns(
            cols, state, previous_epoch, use_current_participation
        )
    if packed is None:
        fallback("pack_registry")
        from ..ops.registry_columns import pack_registry

        return pack_registry(state, previous_epoch, use_current_participation)
    return packed


def _pack_from_columns(cols, state, previous_epoch,
                       use_current_participation) -> "dict | None":
    np = _np()
    vc = cols.validator_columns(state)
    if vc is None:
        return None
    n = len(state.validators)
    part_field = (
        "current_epoch_participation"
        if use_current_participation
        else "previous_epoch_participation"
    )
    if getattr(state, part_field, None) is None:  # phase0 states
        participation = np.zeros(n, dtype=np.uint8)
    else:
        participation = cols.list_column(state, part_field)
        if participation is None:
            return None
    if getattr(state, "inactivity_scores", None) is None:
        inactivity = np.zeros(n, dtype=np.uint64)
    else:
        inactivity = cols.list_column(state, "inactivity_scores")
        if inactivity is None:
            return None
    balances = cols.list_column(state, "balances")
    if balances is None:
        return None
    from ..ops.registry_columns import activity_masks

    active_previous, eligible = activity_masks(
        vc["activation_epoch"],
        vc["exit_epoch"],
        vc["withdrawable_epoch"],
        vc["slashed"],
        previous_epoch,
    )
    return {
        "effective_balance": vc["effective_balance"],
        "slashed": vc["slashed"],
        "active_previous": active_previous,
        "eligible": eligible,
        "previous_participation": participation,
        "inactivity_scores": inactivity,
        "balances": balances,
    }


# ---------------------------------------------------------------------------
# write-direction column commits (the columnar-primary epoch engine,
# models/epoch_vector.py)
# ---------------------------------------------------------------------------


def adopt_list_column(lst, arr, changed_indices, vmax) -> None:
    """Columnar-primary commit of a scalar-list column: ``arr`` is the
    AUTHORITATIVE new content (the epoch engine computed the whole epoch
    on it), the SSZ list is the materialization. One ``bulk_store`` with
    the exact changed indices splices the values in (so incremental HTR
    re-merkleizes only the touched 4096-element groups), and ``arr``
    itself becomes the list's column cache — owned, with a CLEAN dirty
    set — instead of paying a read-direction refresh of rows we just
    wrote. This is the ``_col_dirty`` machinery driven in the write
    direction.

    Ownership contract: the caller HANDS OVER ``arr`` — it must never
    mutate it afterwards (the epoch engine drops its working references
    at commit). ``changed_indices`` must name every position whose value
    differs from the list's current content (the ``bulk_store``
    certification contract). A no-change commit is free."""
    np = _np()
    n = len(lst)
    if np is None or arr.shape[0] != n:
        fallback("adopt_shape")
        bulk_store(lst, [int(x) for x in arr], changed_indices)
        return
    changed = np.asarray(changed_indices, dtype=np.int64)
    if changed.size:
        # hand bulk_store the wire-width column itself: ONE tolist boxing
        # inside it, uniformity certified from the dtype
        bulk_store(lst, arr, changed)
        metrics.counter("ops_vector.bulk_store.calls").inc()
        metrics.counter("ops_vector.bulk_store.elements").inc(
            int(changed.size)
        )
    if lst.__class__ is CachedRootList:
        lst._col_cache = ("list", arr, vmax)
        lst._col_owned = True
        lst._col_dirty = set()
        metrics.counter("ops_vector.columns.adopted").inc()


def install_zero_column(lst, n: int, vmax: int = 0xFF) -> None:
    """Column adoption for a FRESH all-zero list (the participation
    rotation writes ``[0] * n``): the list already holds exactly zeros,
    so no splice is needed — just install the matching zero column as
    the owned, clean cache, and certify uniformity (every element is a
    literal int 0) so the next hash walk skips the type scan."""
    np = _np()
    if np is None or lst.__class__ is not CachedRootList or len(lst) != n:
        return
    dtype = np.uint8 if vmax == 0xFF else np.uint64
    lst._col_cache = ("list", np.zeros(n, dtype=dtype), vmax)
    lst._col_owned = True
    lst._col_dirty = set()
    lst._uniform_kind = ("int",)
    metrics.counter("ops_vector.columns.adopted").inc()


# ---------------------------------------------------------------------------
# block-scoped attestation fast path
# ---------------------------------------------------------------------------

# attestation_fn -> (prepare_fn, helpers_module); each fork's
# block_processing registers its pair at import (models/altair/...py
# bottom), so the engine recognizes exactly the functions whose
# validation it can reuse and falls back on any custom hook.
_ATTESTATION_PREPARERS: dict = {}
_PREPARER_LOCK = threading.Lock()


def register_attestation_preparer(attestation_fn, prepare_fn, helpers) -> None:
    with _PREPARER_LOCK:
        _ATTESTATION_PREPARERS[attestation_fn] = (prepare_fn, helpers)


def process_attestations_batch(state, attestations, context,
                               attestation_fn) -> bool:
    """Apply every attestation of a block through the columnar fast path.

    Returns True when fully applied (validation, participation flags,
    proposer rewards — bit-identical to the scalar loop); False when the
    caller must run the scalar fallback. On a validation error the
    already-processed attestations' flags are committed before the error
    propagates — the exact partial state the sequential loop leaves."""
    n_atts = len(attestations)
    if n_atts < BATCH_MIN_ATTESTATIONS:
        # an EMPTY list is no work at all, not a decline of work
        if n_atts:
            fallback("below_threshold")
        return False
    if _disabled():
        fallback("disabled")
        return False
    entry = _ATTESTATION_PREPARERS.get(attestation_fn)
    if entry is None:
        fallback("unregistered_attestation_fn")
        return False
    if len(state.validators) < BATCH_MIN_VALIDATORS:
        fallback("below_threshold")
        return False
    np = _np()
    if np is None:
        fallback("no_numpy")
        return False
    cur_list = getattr(state, "current_epoch_participation", None)
    prev_list = getattr(state, "previous_epoch_participation", None)
    if cur_list is None or prev_list is None or cur_list is prev_list:
        fallback("participation_shape")
        return False
    cols = columns_for(state)
    if cols is None:
        fallback("columns_unavailable")
        return False
    vc = cols.validator_columns(state)
    cur_col = cols.list_column(state, "current_epoch_participation")
    prev_col = cols.list_column(state, "previous_epoch_participation")
    if vc is None or cur_col is None or prev_col is None:
        fallback("columns_unavailable")
        return False

    prepare, hm = entry
    from .altair.constants import (
        PARTICIPATION_FLAG_WEIGHTS,
        PROPOSER_WEIGHT,
        WEIGHT_DENOMINATOR,
    )

    increment = int(context.EFFECTIVE_BALANCE_INCREMENT)
    base_increments = vc["effective_balance"] // np.uint64(increment)
    brpi = int(hm.get_base_reward_per_increment(state, context))
    proposer_denominator = (
        (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT)
        * WEIGHT_DENOMINATOR
        // PROPOSER_WEIGHT
    )
    # working copies: reads and writes stay here until the single commit
    cur = cur_col.copy()
    prev = prev_col.copy()

    def commit() -> None:
        for arr, orig, lst in (
            (cur, cur_col, cur_list),
            (prev, prev_col, prev_list),
        ):
            changed = np.nonzero(arr != orig)[0]
            if changed.size:
                bulk_store(lst, arr.tolist(), changed)
                metrics.counter("ops_vector.bulk_store.calls").inc()
                metrics.counter("ops_vector.bulk_store.elements").inc(
                    int(changed.size)
                )

    try:
        for attestation in attestations:
            attesting_indices, flag_indices, is_current = prepare(
                state, attestation, context
            )
            k = len(attesting_indices)
            idx = np.fromiter(attesting_indices, np.int64, k)
            arr = cur if is_current else prev
            vals = arr[idx]
            numerator_increments = 0
            mask = 0
            for flag_index in flag_indices:
                bit = np.uint8(1 << flag_index)
                newly = (vals & bit) == 0
                if newly.any():
                    numerator_increments += PARTICIPATION_FLAG_WEIGHTS[
                        flag_index
                    ] * int(base_increments[idx[newly]].sum())
                mask |= 1 << flag_index
            if mask and k:
                arr[idx] = vals | np.uint8(mask)
            proposer_reward = (
                numerator_increments * brpi
            ) // proposer_denominator
            hm.increase_balance(
                state,
                hm.get_beacon_proposer_index(state, context),
                proposer_reward,
            )
    except BaseException:
        # the sequential loop leaves attestations 0..k-1 applied when
        # attestation k fails — commit that exact partial state
        commit()
        raise
    commit()
    metrics.counter("ops_vector.attestations.blocks").inc()
    metrics.counter("ops_vector.attestations.count").inc(n_atts)
    return True


# ---------------------------------------------------------------------------
# columnar epoch-boundary / withdrawal helpers
# ---------------------------------------------------------------------------


def effective_balance_update_hits(state, context):
    """The hysteresis sweep as (index, new_effective_balance) hits —
    exactly the writes the literal loop performs (it only ever stores a
    DIFFERENT value on a threshold crossing, so changed-only is the
    identical state); None = fall back to the scalar loop."""
    np = _np()
    if np is None:
        fallback("no_numpy")
        return None
    cols = columns_for(state)
    vc = cols.validator_columns(state) if cols is not None else None
    balances = cols.list_column(state, "balances") if cols is not None else None
    if vc is None or balances is None:
        fallback("columns_unavailable")
        return None
    eff = vc["effective_balance"]
    increment = int(context.EFFECTIVE_BALANCE_INCREMENT)
    hysteresis_increment = increment // int(context.HYSTERESIS_QUOTIENT)
    down = hysteresis_increment * int(context.HYSTERESIS_DOWNWARD_MULTIPLIER)
    up = hysteresis_increment * int(context.HYSTERESIS_UPWARD_MULTIPLIER)
    # balance + threshold must stay inside the u64 lane (adversarial
    # near-2^64 balances would wrap the comparison)
    top = (1 << 64) - 1 - max(down, up)
    if int(balances.max(initial=0)) > top or int(eff.max(initial=0)) > top:
        fallback("u64_guard")
        return None
    limit = np.uint64(int(context.MAX_EFFECTIVE_BALANCE))
    update = (balances + np.uint64(down) < eff) | (
        eff + np.uint64(up) < balances
    )
    candidate = np.minimum(
        balances - balances % np.uint64(increment), limit
    )
    hit = update & (candidate != eff)
    idxs = np.nonzero(hit)[0]
    return [(int(i), int(candidate[i])) for i in idxs.tolist()]


def withdrawal_columns(state) -> "dict | None":
    """Read-only columns for the capella withdrawals sweep:
    withdrawal_prefix (first credentials byte), withdrawable_epoch,
    effective_balance, balances. None = scalar fallback (counted)."""
    cols = columns_for(state)
    if cols is None:
        fallback("columns_unavailable")
        return None
    vc = cols.validator_columns(state)
    balances = cols.list_column(state, "balances")
    if vc is None or balances is None:
        fallback("columns_unavailable")
        return None
    if balances.shape[0] != vc["withdrawable_epoch"].shape[0]:
        fallback("length_mismatch")
        return None
    return {
        "withdrawal_prefix": vc["withdrawal_prefix"],
        "withdrawable_epoch": vc["withdrawable_epoch"],
        "effective_balance": vc["effective_balance"],
        "balances": balances,
    }
