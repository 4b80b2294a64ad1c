"""Columnar-primary epoch transition engine (the phase0 family).

The ownership inversion this module implements: for the epoch hot path
the ``RegistryColumns`` arrays are the AUTHORITATIVE store of validator
epoch fields and balances, and the SSZ list elements are a
materialization — produced once per epoch, at commit, through
``bulk_store``'s changed-indices contract (``ops_vector.adopt_list_column``
— the ``_col_dirty`` machinery driven in the write direction).
Everything the epoch transition computes between sync and commit reads
and writes the arrays; no stage walks ``state.validators`` elements, so
the pass costs vector passes + a handful of per-hit writes instead of ~10
Python sweeps over a million-validator registry.

phase0's ``process_epoch`` calls ``process_epoch_columnar(state, context,
"phase0")`` first and falls back to its literal stage list when the
engine declines — no numpy, the engine disabled (``ECT_OPS_VECTOR=off`` /
``ECT_EPOCH_VECTOR=off``), registry below ``EPOCH_VECTOR_MIN_VALIDATORS``,
device sweeps installed (``device_sweeps``: the literal list then runs
the hysteresis sweep on the card), or a value outside the u64 lane
contract. The literal loops remain the oracle.

Soundness rules:

* every fallback decision happens BEFORE any state mutation (the
  upfront guards in ``_sync``), so a declined pass leaves the state
  untouched for the literal path — bit-identity is structural;
* scalar container writes that later columnar stages READ (the
  justification checkpoint updates feeding the registry stage's
  finalized-epoch predicate) happen in spec order on the state itself —
  they are O(1);
* the per-epoch memo caches the scalar helpers consult
  (``_total_active_balance_cache``, ``_active_idx_cache``) are SEEDED from
  the columns with exactly the value the scalar sweep would compute, so
  a mid-pass helper call never pays (or needs) a per-validator walk.

justification and rewards are fed by the committee-mask kernel
(``models/committees.py``), with the spec-helper walks as fallback +
oracle.

Telemetry: ``epoch_vector.epochs`` counts engaged passes,
``epoch_vector.fallback.{reason}`` every decline.

Reference parity: ethereum_consensus_tpu/models/epoch_vector.py, the
phase0 family. Left out until the slices that need them: the altair
stages (justification, inactivity, rewards), the numeric xp kernels and
the fused device epoch kernel (B3, with the altair slice), the mesh
consult (B9), electra's pending deposits and consolidations, the
sync-committee branch, and the trace spans and routing journal
(telemetry slice).
"""

from __future__ import annotations

from .. import _device_flags, _env
from ..primitives import FAR_FUTURE_EPOCH, GENESIS_EPOCH
from ..telemetry import metrics
from . import ops_vector

__all__ = [
    "process_epoch_columnar",
    "EPOCH_VECTOR_MIN_VALIDATORS",
]

# Below this registry size the literal Python stages win (column sync +
# working-array copies cost more than the loops they replace); the
# differential tests lower it to 0 to force the engine on tiny states.
EPOCH_VECTOR_MIN_VALIDATORS = 1 << 12

_DISABLE_ENV = "ECT_EPOCH_VECTOR"  # =off disables just this engine

_U64_MAX = (1 << 64) - 1
# every balance/epoch value the pass computes with stays below 2^63 so
# u64 adds can never wrap mid-kernel; states outside the lane fall back
# to the literal loops BEFORE any mutation
_LANE_MAX = 1 << 63


def _np():
    try:
        import numpy

        return numpy
    except Exception:  # noqa: BLE001 — environment without numpy
        return None


def fallback(reason: str) -> None:
    """Count a decline to the literal epoch path. EVERY decline path runs
    through here — including the deliberate ones (``below_threshold``,
    ``device_sweeps``): a production-threshold decline is a routing
    decision worth seeing."""
    metrics.counter(f"epoch_vector.fallback.{reason}").inc()


def _disabled() -> bool:
    return _env.flag_off(_DISABLE_ENV) or _env.flag_off(ops_vector._DISABLE_ENV)


# ---------------------------------------------------------------------------
# the working set
# ---------------------------------------------------------------------------

# Per-fork knobs of the stages below. Only phase0 is ported; the other
# forks' rows (and the knobs only they read) return with their slices.
# slash_mult: the fork's proportional slashing multiplier attribute
_FORK_CFG = {
    "phase0": dict(slash_mult="PROPORTIONAL_SLASHING_MULTIPLIER"),
}


class _EpochColumns:
    """The pass's working set: read-only BASE views straight off the
    list-resident column caches, and owned WORK copies the stages
    mutate. Commit diffs work against base per column."""

    __slots__ = (
        "np", "state", "context", "cfg", "n", "cur", "prev",
        "increment",
        # base views (never written)
        "b_eff", "b_elig", "b_act", "b_exit", "b_wdr",
        "b_balances",
        "slashed",
        # working copies (authoritative during the pass)
        "eff", "elig", "act", "exit", "wdr",
        "balances",
        # lazy scalars
        "_total_active", "_active_cur_count",
        # masks at the pre-pass registry (activity is stable within the
        # epoch window — every spec write targets future epochs)
        "active_prev", "active_cur", "eligible",
    )


def _sync(state, context, fork):
    """Build the working set, running EVERY fallback guard before any
    mutation. Returns None to decline (state untouched)."""
    np = _np()
    cols = ops_vector.columns_for(state)
    if cols is None:
        fallback("columns_unavailable")
        return None
    vc = cols.validator_columns(state)
    balances = cols.list_column(state, "balances")
    if vc is None or balances is None:
        fallback("columns_unavailable")
        return None
    n = len(state.validators)
    if balances.shape[0] != n:
        fallback("length_mismatch")
        return None
    ec = _EpochColumns()
    ec.np = np
    ec.state = state
    ec.context = context
    ec.cfg = _FORK_CFG[fork]
    ec.n = n
    cur = int(state.slot) // int(context.SLOTS_PER_EPOCH)
    ec.cur = cur
    ec.prev = GENESIS_EPOCH if cur == GENESIS_EPOCH else cur - 1
    ec.increment = int(context.EFFECTIVE_BALANCE_INCREMENT)
    ec.b_eff = vc["effective_balance"]
    ec.b_elig = vc["activation_eligibility_epoch"]
    ec.b_act = vc["activation_epoch"]
    ec.b_exit = vc["exit_epoch"]
    ec.b_wdr = vc["withdrawable_epoch"]
    ec.slashed = vc["slashed"]
    ec.b_balances = balances

    # --- u64 lane guards: everything the pass adds/multiplies must stay
    # below 2^63 so no kernel op can wrap; a state outside the lane
    # (adversarial near-2^64 values) declines BEFORE any mutation and
    # the literal loops keep their exact big-int/structured-error paths
    if int(ec.b_balances.max(initial=0)) >= _LANE_MAX:
        fallback("u64_guard")
        return None
    if int(ec.b_eff.max(initial=0)) >= _LANE_MAX:
        fallback("u64_guard")
        return None
    far = np.uint64(FAR_FUTURE_EPOCH)
    real_exits = ec.b_exit[ec.b_exit != far]
    if real_exits.size and int(real_exits.max()) >= _LANE_MAX:
        fallback("u64_guard")
        return None
    if cur >= _LANE_MAX - (2 + int(context.MAX_SEED_LOOKAHEAD)):
        fallback("u64_guard")
        return None
    # masked eff sums must be exact in u64: cap n * max(eff) below 2^64
    eff_max = int(ec.b_eff.max(initial=0))
    if n and eff_max * n >= 1 << 64:
        fallback("u64_guard")
        return None

    # activity masks at the PRE-PASS registry: every spec mutation of
    # the activity schedule targets a future epoch (the
    # get_active_validator_indices contract), so these stay exact for
    # the whole pass
    prev64 = np.uint64(ec.prev)
    cur64 = np.uint64(cur)
    ec.active_prev = (ec.b_act <= prev64) & (prev64 < ec.b_exit)
    ec.active_cur = (ec.b_act <= cur64) & (cur64 < ec.b_exit)
    ec.eligible = ec.active_prev | (
        ec.slashed & (prev64 + np.uint64(1) < ec.b_wdr)
    )

    # the working set STARTS as the base views (read-only — an
    # accidental in-place write raises instead of corrupting the cache);
    # stages that rebind (rewards, hysteresis) replace the reference with
    # a fresh owned array, and in-place writers (registry hits,
    # slashings) take an owned copy via _own on their FIRST actual
    # write — a typical epoch therefore copies only the columns it
    # really changes
    ec.eff = ec.b_eff
    ec.elig = ec.b_elig
    ec.act = ec.b_act
    ec.exit = ec.b_exit
    ec.wdr = ec.b_wdr
    ec.balances = ec.b_balances
    ec._total_active = None
    ec._active_cur_count = None
    return ec


def _own(ec, name: str):
    """Copy-on-first-write for a working column: the base views are
    read-only, so in-place stages must take ownership before writing."""
    arr = getattr(ec, name)
    if not arr.flags.writeable:
        arr = arr.copy()
        setattr(ec, name, arr)
    return arr


def _total_active(ec) -> int:
    """max(increment, sum of active-at-current effective balances) —
    exactly ``get_total_active_balance``'s value; seeded into the
    state's memo so every scalar helper call mid-pass hits it."""
    if ec._total_active is None:
        total = max(ec.increment, int(ec.eff[ec.active_cur].sum()))
        ec._total_active = total
        ec.state.__dict__["_total_active_balance_cache"] = (
            (ec.cur, ec.n),
            total,
        )
    return ec._total_active


def _active_cur_count(ec) -> int:
    if ec._active_cur_count is None:
        ec._active_cur_count = int(ec.active_cur.sum())
    return ec._active_cur_count


def _churn_limit(ec) -> int:
    ctx = ec.context
    return max(
        int(ctx.min_per_epoch_churn_limit),
        _active_cur_count(ec) // int(ctx.churn_limit_quotient),
    )


def _seed_active_indices(ec, epoch: int, mask) -> tuple:
    """Materialize (once) the active-index tuple for ``epoch`` from the
    columns and install it in the state's ``_active_idx_cache`` with the
    helper's exact rebind discipline — the committee machinery (phase0
    pendings, sync-committee sampling) then never pays the per-validator
    sweep."""
    state = ec.state
    key = (epoch, ec.n)
    cache = state.__dict__.get("_active_idx_cache")
    if isinstance(cache, dict):
        hit = cache.get(key)
        if hit is not None:
            return hit
        items = list(cache.items())
    else:
        items = []
    out = tuple(ec.np.nonzero(mask)[0].tolist())
    if len(items) >= 4:
        items = items[1:]
    state.__dict__["_active_idx_cache"] = dict(items + [(key, out)])
    return out


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


def _justification_phase0(ec) -> None:
    if ec.cur <= GENESIS_EPOCH + 1:
        return
    from .committees import pending_masks_for
    from .phase0 import epoch_processing as pep
    from .phase0 import helpers as h
    from .phase0.epoch_processing import weigh_justification_and_finalization

    state, context, np = ec.state, ec.context, ec.np
    _seed_active_indices(ec, ec.prev, ec.active_prev)
    _seed_active_indices(ec, ec.cur, ec.active_cur)

    # the committee-mask kernel (models/committees.py): target masks for
    # both epochs off ONE shuffled table + bitfield pass per epoch; its
    # bundle is memoized on the state, so the rewards stage reuses it
    prev_bundle = pending_masks_for(state, ec.prev, context)
    cur_bundle = (
        pending_masks_for(state, ec.cur, context)
        if prev_bundle is not None
        else None
    )
    if prev_bundle is not None and cur_bundle is not None:
        unslashed = ~ec.slashed
        previous_target = max(
            ec.increment, int(ec.eff[prev_bundle.target & unslashed].sum())
        )
        current_target = max(
            ec.increment, int(ec.eff[cur_bundle.target & unslashed].sum())
        )
        weigh_justification_and_finalization(
            state, _total_active(ec), previous_target, current_target,
            context,
        )
        return

    def attesting_balance(atts) -> int:
        mask = np.zeros(ec.n, dtype=bool)
        for a in atts:
            idx = h.get_attesting_indices(
                state, a.data, a.aggregation_bits, context
            )
            mask[np.fromiter(idx, dtype=np.int64, count=len(idx))] = True
        mask &= ~ec.slashed
        return max(ec.increment, int(ec.eff[mask].sum()))

    previous_atts = pep.get_matching_target_attestations(
        state, ec.prev, context
    )
    current_atts = pep.get_matching_target_attestations(
        state, ec.cur, context
    )
    weigh_justification_and_finalization(
        state,
        _total_active(ec),
        attesting_balance(previous_atts),
        attesting_balance(current_atts),
        context,
    )


def _rewards_phase0(ec) -> None:
    if ec.cur == GENESIS_EPOCH:
        return
    from .phase0 import epoch_processing as pep
    from .phase0 import helpers as h

    np = ec.np
    _seed_active_indices(ec, ec.prev, ec.active_prev)
    _seed_active_indices(ec, ec.cur, ec.active_cur)
    # seed the total-active-balance memo from the columns BEFORE the
    # deltas consult it: at the epoch-1 boundary justification is
    # skipped (cur <= GENESIS+1) and nothing else has seeded it — an
    # unseeded memo costs get_total_active_balance a full per-validator
    # Python sweep inside the hot pass
    _total_active(ec)
    # hand the deltas the pass's own column views (working = base here:
    # nothing earlier in the pass mutates these columns for phase0), so
    # the activity masks aren't re-derived mid-pass
    rewards, penalties = pep._attestation_deltas_vectorized(
        ec.state, ec.context,
        packed={
            "effective_balance": ec.eff,
            "slashed": ec.slashed,
            "active_previous": ec.active_prev,
            "eligible": ec.eligible,
        },
    )
    raised = ec.balances + rewards
    if bool((raised < ec.balances).any()):
        # u64 overflow: commit, then re-run literally so checked_add
        # raises the structured error at the exact index
        _commit(ec)
        rewards_l, penalties_l = pep._get_attestation_deltas_literal(
            ec.state, ec.context
        )
        for index in range(ec.n):
            h.increase_balance(ec.state, index, rewards_l[index])
            h.decrease_balance(ec.state, index, penalties_l[index])
        raise _PassComplete()
    ec.balances = np.where(raised >= penalties, raised - penalties, 0)


def _registry_updates(ec) -> None:
    """Queue entries, ejections and activations over the working
    columns. Ejection exit scheduling replicates the literal
    ``initiate_validator_exit`` incrementally."""
    np = ec.np
    context = ec.context
    from .phase0.helpers import compute_activation_exit_epoch

    far = np.uint64(FAR_FUTURE_EPOCH)
    balance_rule = ec.eff == np.uint64(int(context.MAX_EFFECTIVE_BALANCE))
    queue_entry = (ec.elig == far) & balance_rule
    if bool(queue_entry.any()):
        _own(ec, "elig")[queue_entry] = np.uint64(ec.cur + 1)

    ejection = ec.active_cur & (
        ec.eff <= np.uint64(int(context.ejection_balance))
    )
    hits = np.nonzero(ejection)[0]
    if hits.size:
        _initiate_exits_phase0(ec, hits.tolist())

    # ec.elig already carries the queue-entry writes, so this is the
    # literal "re-read eligibility" order
    activatable = (
        ec.elig <= np.uint64(int(ec.state.finalized_checkpoint.epoch))
    ) & (ec.act == far)
    cand = np.nonzero(activatable)[0]
    if cand.size == 0:
        return
    activation_epoch = np.uint64(
        compute_activation_exit_epoch(ec.cur, context)
    )
    # ascending (eligibility, index) queue, churn-capped
    order = np.argsort(ec.elig[cand], kind="stable")
    queue = cand[order]
    limit = _churn_limit(ec)
    if limit > 0:
        _own(ec, "act")[queue[:limit]] = activation_epoch


def _initiate_exits_phase0(ec, indices) -> None:
    """The literal ``initiate_validator_exit`` for a batch of ejections,
    maintained incrementally: the literal recomputes (max exit epoch,
    churn at it) per call — after each write the max is the write's
    epoch, so the running pair reproduces every per-call recompute."""
    np = ec.np
    context = ec.context
    from .phase0.helpers import compute_activation_exit_epoch

    far = np.uint64(FAR_FUTURE_EPOCH)
    _own(ec, "exit")
    _own(ec, "wdr")
    real = ec.exit[ec.exit != far]
    aee = compute_activation_exit_epoch(ec.cur, context)
    exit_queue_epoch = max(int(real.max()) if real.size else 0, aee)
    churn = int((ec.exit == np.uint64(exit_queue_epoch)).sum())
    limit = _churn_limit(ec)
    delay = int(context.min_validator_withdrawability_delay)
    for i in indices:
        if int(ec.exit[i]) != FAR_FUTURE_EPOCH:
            continue
        if churn >= limit:
            exit_queue_epoch += 1
            churn = 0
        ec.exit[i] = np.uint64(exit_queue_epoch)
        ec.wdr[i] = np.uint64(exit_queue_epoch + delay)
        churn += 1


def _slashings(ec) -> None:
    np = ec.np
    context = ec.context
    total_balance = _total_active(ec)
    adjusted = min(
        sum(ec.state.slashings) * int(getattr(context, ec.cfg["slash_mult"])),
        total_balance,
    )
    target = ec.cur + int(context.EPOCHS_PER_SLASHINGS_VECTOR) // 2
    mask = ec.slashed & (ec.wdr == np.uint64(target))
    hits = np.nonzero(mask)[0]
    increment = ec.increment
    if hits.size:
        _own(ec, "balances")
    for i in hits.tolist():
        # exact big-int math per hit (the eff//inc * adjusted product
        # exceeds u64 at mainnet totals); hits are the few slashed
        # validators at their halfway point, never a registry sweep
        penalty_numerator = (int(ec.eff[i]) // increment) * adjusted
        penalty = penalty_numerator // total_balance * increment
        bal = int(ec.balances[i])
        ec.balances[i] = np.uint64(bal - penalty if bal > penalty else 0)


def _effective_balance_updates(ec) -> None:
    """The hysteresis sweep on the working columns."""
    np = ec.np
    context = ec.context
    # the ONLY spec site that mutates effective balances: drop the
    # total-active-balance memo exactly like the literal stage does
    ec.state.__dict__.pop("_total_active_balance_cache", None)
    increment = ec.increment
    hysteresis_increment = increment // int(context.HYSTERESIS_QUOTIENT)
    down = hysteresis_increment * int(context.HYSTERESIS_DOWNWARD_MULTIPLIER)
    up = hysteresis_increment * int(context.HYSTERESIS_UPWARD_MULTIPLIER)
    limit = np.uint64(int(context.MAX_EFFECTIVE_BALANCE))
    update = (ec.balances + np.uint64(down) < ec.eff) | (
        ec.eff + np.uint64(up) < ec.balances
    )
    candidate = np.minimum(
        ec.balances - ec.balances % np.uint64(increment), limit
    )
    ec.eff = np.where(update, candidate, ec.eff)


# ---------------------------------------------------------------------------
# commit — materialize the columns back into the SSZ lists
# ---------------------------------------------------------------------------

_VAL_FIELD_COLS = (
    ("effective_balance", "eff", "b_eff"),
    ("activation_eligibility_epoch", "elig", "b_elig"),
    ("activation_epoch", "act", "b_act"),
    ("exit_epoch", "exit", "b_exit"),
    ("withdrawable_epoch", "wdr", "b_wdr"),
)


def _commit(ec) -> None:
    """Materialize: ONE adopted bulk_store for the balances with exact
    changed indices, per-hit instrumented writes for the handful of
    changed validator epoch fields. After this the SSZ state and the (now
    clean, owned) column caches agree by construction."""
    np = ec.np
    state = ec.state
    if ec.balances is not ec.b_balances:
        ops_vector.adopt_list_column(
            state.balances,
            ec.balances,
            np.nonzero(ec.balances != ec.b_balances)[0],
            _U64_MAX,
        )
    validators = state.validators
    writes = 0
    for field, work_name, base_name in _VAL_FIELD_COLS:
        work = getattr(ec, work_name)
        base = getattr(ec, base_name)
        if work is base:
            continue
        for i in np.nonzero(work != base)[0].tolist():
            setattr(validators[i], field, int(work[i]))
            writes += 1
    if writes:
        metrics.counter("epoch_vector.validator_writes").inc(writes)


class _PassComplete(Exception):
    """Internal control flow: a stage finished the pass itself (the
    literal overflow mirror, which must raise the structured error after
    committing). Never escapes ``process_epoch_columnar``."""


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------


def process_epoch_columnar(state, context, fork: str) -> bool:
    """Run the fork's full epoch transition as one vectorized pass over
    the authoritative columns. Returns False (state untouched) when the
    engine declines — the caller then runs its literal stage list."""
    n = len(state.validators)
    if n < EPOCH_VECTOR_MIN_VALIDATORS:
        # a deliberate cost threshold, not a degradation — but still a
        # routing decision, counted like every other decline
        fallback("below_threshold")
        return False
    if _disabled():
        fallback("disabled")
        return False
    if _device_flags.sweeps_enabled(n):
        # ops.install routed the sweeps to the card: phase0 keeps the
        # literal path's device hysteresis routing
        fallback("device_sweeps")
        return False
    if _np() is None:
        fallback("no_numpy")
        return False
    ec = _sync(state, context, fork)
    if ec is None:
        return False
    from .phase0.epoch_processing import (
        process_eth1_data_reset,
        process_historical_roots_update,
        process_randao_mixes_reset,
        process_slashings_reset,
    )

    try:
        _justification_phase0(ec)
        _rewards_phase0(ec)
        _registry_updates(ec)
        _slashings(ec)
        process_eth1_data_reset(state, context)
        _effective_balance_updates(ec)
        _commit(ec)
    except _PassComplete:
        metrics.counter("epoch_vector.epochs").inc()
        return True
    process_slashings_reset(state, context)
    process_randao_mixes_reset(state, context)
    process_historical_roots_update(state, context)
    from .committees import drop_masks_memo

    # pending lists swap: this epoch's mask bundles are done
    drop_masks_memo(state)
    state.previous_epoch_attestations = state.current_epoch_attestations
    state.current_epoch_attestations = []
    metrics.counter("epoch_vector.epochs").inc()
    return True
