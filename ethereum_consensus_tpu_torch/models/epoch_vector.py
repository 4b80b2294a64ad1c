"""Columnar-primary epoch transition engine (the phase0 and altair
families: phase0, altair, bellatrix, capella and deneb).

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

Each fork's ``process_epoch`` calls ``process_epoch_columnar(state,
context, fork)`` first and falls back to its literal stage list when the
engine declines — no numpy, the engine disabled (``ECT_OPS_VECTOR=off`` /
``ECT_EPOCH_VECTOR=off``), registry below ``EPOCH_VECTOR_MIN_VALIDATORS``,
phase0 with device sweeps installed (``device_sweeps``: the literal list
then runs the hysteresis sweep on the card), or a value outside the u64
lane contract. The literal loops remain the oracle.

The altair family's numeric cores (``inactivity_scores_kernel``,
``flag_deltas_kernel``, ``apply_delta_pairs_kernel``) are numpy host
functions with every scalar wrapped to uint64; the u64-overflow guards
live in the caller, which routes pathological states to exact Python-int
paths before any kernel runs. With ``ops.install()`` routing the sweeps to
the card, the altair-family inactivity and rewards stages collapse into
ONE launch of the fused epoch kernel (``ops/epoch.py``, B3) — the packed
columns upload once — with the staged host kernels taking over only on
the spec-preserving declines ``u64_product`` and ``wrap_guard``, counted
in ``epoch_vector.fused_fallback.{reason}``. A build or launch failure of
the kernel raises.

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

phase0's justification and rewards are fed by the committee-mask kernel
(``models/committees.py``), with the spec-helper walks as fallback +
oracle.

With ``ECT_MESH`` set, the pass consults the mesh runtime
(``parallel/runtime.py``) once: an engaged runner (``parallel/epoch.py``
``MeshEpochSweeps``) takes the fused route sharded (``ec.mesh.fused``), and
the staged inactivity and rewards stages sharded where the fused route
declines. The runtime counts every decline; a failing shard raises.

Telemetry: ``epoch_vector.epochs`` counts engaged passes,
``epoch_vector.fallback.{reason}`` every decline,
``epoch_vector.fused.device`` every fused launch and
``epoch_vector.fused.mesh`` every sharded fused pass.

Reference parity: ethereum_consensus_tpu/models/epoch_vector.py, the
phase0, altair, bellatrix, capella and deneb rows. Left out until the
slices that need them: electra's row and stages (its unbounded activations,
pending deposits and consolidations),
``jitted_kernels`` / ``kernel_cache_census`` (the port calls
``ops/epoch.py`` directly), and the trace spans and routing journal
(telemetry slice).
"""

from __future__ import annotations

from .. import _device_flags, _env
from ..primitives import FAR_FUTURE_EPOCH, GENESIS_EPOCH
from ..telemetry import metrics
from . import ops_vector

__all__ = [
    "process_epoch_columnar",
    "inactivity_scores_kernel",
    "flag_deltas_kernel",
    "apply_delta_pairs_kernel",
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
# numeric host kernels (numpy; scalars uint64)
# ---------------------------------------------------------------------------


def inactivity_scores_kernel(xp, scores, eligible, participating, bias,
                             recovery_rate, leaking):
    """altair ``process_inactivity_updates`` over columns — per eligible
    validator: participating → score -= min(1, score); absent → score +=
    bias; then (outside a leak) score -= min(recovery_rate, score)."""
    one = xp.uint64(1)
    hit = eligible & participating
    miss = eligible & ~participating
    new = xp.where(hit, scores - xp.minimum(one, scores), scores)
    new = xp.where(miss, new + xp.uint64(bias), new)
    if not leaking:
        rec = xp.uint64(recovery_rate)
        new = xp.where(eligible, new - xp.minimum(rec, new), new)
    return new


def flag_deltas_kernel(xp, base_reward, eligible, unslashed, weight,
                       unslashed_increments, active_increments,
                       weight_denominator, leaking, is_head_flag):
    """One participation flag's (rewards, penalties) pair — the altair
    flag-delta formula with the spec's two-step floor division; products
    stay in u64 by the caller's lane guard."""
    zero = xp.uint64(0)
    if leaking:
        rewards = xp.zeros_like(base_reward)  # no flag rewards in a leak
    else:
        attesting = eligible & unslashed
        rewards = xp.where(
            attesting,
            (
                base_reward
                * xp.uint64(weight)
                * xp.uint64(unslashed_increments)
            )
            // xp.uint64(active_increments * weight_denominator),
            zero,
        )
    if is_head_flag:
        penalties = xp.zeros_like(base_reward)
    else:
        absent = eligible & ~unslashed
        penalties = xp.where(
            absent,
            base_reward * xp.uint64(weight) // xp.uint64(weight_denominator),
            zero,
        )
    return rewards, penalties


def apply_delta_pairs_kernel(xp, balances, pairs):
    """Apply (rewards, penalties) pairs IN SEQUENCE, saturating at zero
    between pairs — the spec's application order (summing first and
    clamping once diverges for a low-balance validator whose early-pair
    penalty saturates before a later-pair reward lands)."""
    zero = xp.uint64(0)
    for rewards, penalties in pairs:
        raised = balances + rewards
        balances = xp.where(raised >= penalties, raised - penalties, zero)
    return balances


# ---------------------------------------------------------------------------
# the working set
# ---------------------------------------------------------------------------

# Per-fork knobs of the stages below.
# family: "phase0" (pending-attestation rewards) | "altair" (flag rewards)
# quot: the fork's inactivity-penalty quotient attribute
# slash_mult: the fork's proportional slashing multiplier attribute
# historical: "roots" | "summaries"
# activation: "churn" (exit churn cap) | "activation_churn" (EIP-7514)
_FORK_CFG = {
    "phase0": dict(family="phase0", quot=None,
                   slash_mult="PROPORTIONAL_SLASHING_MULTIPLIER",
                   historical="roots", activation="churn"),
    "altair": dict(family="altair", quot="INACTIVITY_PENALTY_QUOTIENT_ALTAIR",
                   slash_mult="PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR",
                   historical="roots", activation="churn"),
    "bellatrix": dict(family="altair",
                      quot="INACTIVITY_PENALTY_QUOTIENT_BELLATRIX",
                      slash_mult="PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX",
                      historical="roots", activation="churn"),
    "capella": dict(family="altair",
                    quot="INACTIVITY_PENALTY_QUOTIENT_BELLATRIX",
                    slash_mult="PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX",
                    historical="summaries", activation="churn"),
    "deneb": dict(family="altair",
                  quot="INACTIVITY_PENALTY_QUOTIENT_BELLATRIX",
                  slash_mult="PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX",
                  historical="summaries", activation="activation_churn"),
}

_TIMELY_TARGET_FLAG_INDEX = 1  # altair constants; checked at engine entry


class _EpochColumns:
    """The pass's working set: read-only BASE views straight off the
    list-resident column caches, and owned WORK copies the stages
    mutate. Commit diffs work against base per column."""

    __slots__ = (
        "np", "state", "context", "cfg", "n", "cur", "prev",
        "increment",
        # base views (never written)
        "b_eff", "b_elig", "b_act", "b_exit", "b_wdr",
        "b_balances", "b_inact",
        "slashed", "prev_part", "cur_part",
        # working copies (authoritative during the pass)
        "eff", "elig", "act", "exit", "wdr",
        "balances", "inact",
        # lazy scalars
        "_total_active", "_active_cur_count",
        # masks at the pre-pass registry (activity is stable within the
        # epoch window — every spec write targets future epochs)
        "active_prev", "active_cur", "eligible",
        # the mesh runner for this pass (parallel/runtime.py) — None when
        # the mesh is off or declined, and the unsharded kernels run
        "mesh",
        # True when ops.install routed the sweeps device-ward: inactivity
        # and rewards run as one launch of the fused epoch kernel
        "fused",
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
    if ec.cfg["family"] == "altair":
        prev_part = cols.list_column(state, "previous_epoch_participation")
        cur_part = cols.list_column(state, "current_epoch_participation")
        inact = cols.list_column(state, "inactivity_scores")
        if prev_part is None or cur_part is None or inact is None:
            fallback("columns_unavailable")
            return None
        if (
            prev_part.shape[0] != n
            or cur_part.shape[0] != n
            or inact.shape[0] != n
        ):
            fallback("length_mismatch")
            return None
        ec.prev_part = prev_part
        ec.cur_part = cur_part
        ec.b_inact = inact
    else:
        ec.prev_part = ec.cur_part = ec.b_inact = None

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
    if ec.b_inact is not None:
        bias = int(context.inactivity_score_bias)
        if int(ec.b_inact.max(initial=0)) >= _U64_MAX - bias:
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

    if ec.cfg["family"] == "altair" and cur != GENESIS_EPOCH:
        # rewards-kernel product guard, BEFORE any mutation: the largest
        # product formed is base_reward * weight(<=64) * increments, so
        # bound it with the whole-registry increment ceiling. Real
        # states clear this by ~10 bits; a decline costs nothing.
        from .phase0.helpers import integer_squareroot

        total_active = max(
            ec.increment, int(ec.b_eff[ec.active_cur].sum())
        )
        brpi = (
            ec.increment
            * int(context.BASE_REWARD_FACTOR)
            // integer_squareroot(total_active)
        )
        max_base_reward = (eff_max // ec.increment) * brpi
        incr_ceiling = max(1, n * (eff_max // ec.increment))
        if max_base_reward * 64 * incr_ceiling >= 1 << 64:
            fallback("u64_guard")
            return None

    # the working set STARTS as the base views (read-only — an
    # accidental in-place write raises instead of corrupting the cache);
    # stages that rebind (rewards, inactivity, hysteresis) replace the
    # reference with a fresh owned array, and in-place writers (registry
    # hits, slashings) take an owned copy via _own on their FIRST actual
    # write — a typical epoch therefore copies only the columns it really
    # changes
    ec.eff = ec.b_eff
    ec.elig = ec.b_elig
    ec.act = ec.b_act
    ec.exit = ec.b_exit
    ec.wdr = ec.b_wdr
    ec.balances = ec.b_balances
    ec.inact = ec.b_inact
    ec._total_active = None
    ec._active_cur_count = None
    ec.mesh = None
    ec.fused = False
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


def _flag_mask(ec, participation, flag_index: int):
    np = ec.np
    return (
        (participation >> np.uint8(flag_index)) & np.uint8(1)
    ).astype(bool)


# ---------------------------------------------------------------------------
# stages (altair family)
# ---------------------------------------------------------------------------


def _justification_altair(ec) -> None:
    if ec.cur <= GENESIS_EPOCH + 1:
        return
    from .phase0.epoch_processing import weigh_justification_and_finalization

    unslashed = ~ec.slashed
    prev_mask = (
        ec.active_prev
        & unslashed
        & _flag_mask(ec, ec.prev_part, _TIMELY_TARGET_FLAG_INDEX)
    )
    cur_mask = (
        ec.active_cur
        & unslashed
        & _flag_mask(ec, ec.cur_part, _TIMELY_TARGET_FLAG_INDEX)
    )
    total_active = _total_active(ec)
    previous_target = max(ec.increment, int(ec.eff[prev_mask].sum()))
    current_target = max(ec.increment, int(ec.eff[cur_mask].sum()))
    weigh_justification_and_finalization(
        ec.state, total_active, previous_target, current_target, ec.context
    )


def _inactivity_updates(ec, leaking: bool) -> None:
    participating = (
        ec.active_prev
        & ~ec.slashed
        & _flag_mask(ec, ec.prev_part, _TIMELY_TARGET_FLAG_INDEX)
    )
    context = ec.context
    bias = int(context.inactivity_score_bias)
    recovery = int(context.inactivity_score_recovery_rate)
    if ec.mesh is not None:
        # the sharded sweep (parallel/epoch.py); a failing shard raises
        ec.inact = ec.mesh.inactivity_scores(
            ec.inact, ec.eligible, participating, bias, recovery, leaking
        )
        return
    ec.inact = inactivity_scores_kernel(
        ec.np,
        ec.inact,
        ec.eligible,
        participating,
        bias,
        recovery,
        leaking,
    )


def _rewards_altair(ec, leaking: bool) -> None:
    """Flag deltas ×3 + inactivity penalties, applied in sequence with
    zero saturation — the literal helpers' exact integer semantics over
    the working columns. Overflow on application (unreachable for real
    balances) mirrors the literal fallback: it applies the SAME deltas
    per index on the real state so ``checked_add`` raises its structured
    error at the exact index — committing the stages so far first."""
    np = ec.np
    context = ec.context
    from .altair.constants import (
        PARTICIPATION_FLAG_WEIGHTS,
        TIMELY_HEAD_FLAG_INDEX,
        WEIGHT_DENOMINATOR,
    )

    increment = ec.increment
    brpi, active_increments = _reward_scalars(ec)
    if ec.mesh is not None:
        new_balances = _mesh_rewards(ec, brpi, active_increments, leaking)
        if new_balances is not None:
            ec.balances = new_balances
            return
    base_reward = (ec.eff // np.uint64(increment)) * np.uint64(brpi)
    unslashed_all = ~ec.slashed
    pairs = []
    target_unslashed = None
    for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
        unslashed = (
            ec.active_prev
            & unslashed_all
            & _flag_mask(ec, ec.prev_part, flag_index)
        )
        if flag_index == _TIMELY_TARGET_FLAG_INDEX:
            target_unslashed = unslashed
        # get_total_balance floors at one increment
        unslashed_increments = (
            max(increment, int(ec.eff[unslashed].sum())) // increment
        )
        pairs.append(
            flag_deltas_kernel(
                np,
                base_reward,
                ec.eligible,
                unslashed,
                int(weight),
                unslashed_increments,
                active_increments,
                int(WEIGHT_DENOMINATOR),
                leaking,
                flag_index == TIMELY_HEAD_FLAG_INDEX,
            )
        )

    # inactivity penalties off the POST-UPDATE scores (spec order)
    scores = ec.inact
    missed = ec.eligible & ~target_unslashed
    denominator = _penalty_denominator(ec)
    penalties = np.zeros(ec.n, dtype=np.uint64)
    if ec.n == 0 or int(ec.eff.max(initial=0)) * int(
        scores.max(initial=0)
    ) < 1 << 64:
        penalties[missed] = (
            ec.eff[missed] * scores[missed] // np.uint64(denominator)
        )
    else:
        # pathological scores: exact per-index Python ints clamped to the
        # u64 lane — a penalty at the clamp already saturates any real
        # balance to zero, so the applied result is unchanged
        for i in np.nonzero(missed)[0]:
            penalties[i] = min(
                int(ec.eff[i]) * int(scores[i]) // denominator, _U64_MAX
            )
    pairs.append((np.zeros(ec.n, dtype=np.uint64), penalties))

    # apply the pairs in spec sequence (apply_delta_pairs_kernel's exact
    # ops, unrolled here so the per-pair wrap check matches the literal
    # vector path's overflow contract; the _sync guards make the wrap
    # branch unreachable, but a guard regression must degrade to the
    # structured error, never to silently wrapped balances)
    balances = ec.balances
    zero = np.uint64(0)
    for rewards, penalties in pairs:
        raised = balances + rewards
        if bool((raised < balances).any()):
            return _rewards_literal_apply(ec, pairs)
        balances = np.where(raised >= penalties, raised - penalties, zero)
    ec.balances = balances


def _reward_scalars(ec) -> "tuple[int, int]":
    """(base reward per increment, active increments) of the pass."""
    from .phase0.helpers import integer_squareroot

    total_active = _total_active(ec)
    brpi = (
        ec.increment
        * int(ec.context.BASE_REWARD_FACTOR)
        // integer_squareroot(total_active)
    )
    return brpi, total_active // ec.increment


def _penalty_denominator(ec) -> int:
    context = ec.context
    return int(context.inactivity_score_bias) * int(
        getattr(context, ec.cfg["quot"])
    )


def _mesh_rewards(ec, brpi: int, active_increments: int, leaking: bool):
    """Route the whole rewards stage through the mesh runner (one sharded
    sweep: per-flag psum sums, flag deltas, inactivity penalties and the
    in-order application — parallel/epoch.py). Returns the new balances
    column, or None with the decline counted: the host stage then
    recomputes everything. The declines preserve the spec (a product past
    the u64 lane, a wrap the guards should have made unreachable); a
    failing shard raises."""
    from ..parallel import runtime as _mesh_runtime
    from .altair.constants import (
        PARTICIPATION_FLAG_WEIGHTS,
        TIMELY_HEAD_FLAG_INDEX,
        WEIGHT_DENOMINATOR,
    )

    # the host stage clamps pathological eff*score products through exact
    # python ints — a kernel cannot, so those states decline up front
    if ec.n and int(ec.eff.max(initial=0)) * int(ec.inact.max(initial=0)) >= 1 << 64:
        _mesh_runtime.decline("epoch", "u64_product")
        return None
    new_balances = ec.mesh.rewards(
        ec.balances, ec.eff, ec.prev_part, ec.slashed, ec.active_prev,
        ec.eligible, ec.inact,
        increment=ec.increment,
        brpi=brpi,
        active_increments=active_increments,
        denominator=_penalty_denominator(ec),
        weights=tuple(int(w) for w in PARTICIPATION_FLAG_WEIGHTS),
        weight_denominator=int(WEIGHT_DENOMINATOR),
        leaking=leaking,
        head_flag_index=int(TIMELY_HEAD_FLAG_INDEX),
        target_flag_index=_TIMELY_TARGET_FLAG_INDEX,
    )
    if new_balances is None:
        # a u64 wrap the lane guards should have made unreachable: the host
        # path re-runs and its literal mirror raises the structured error
        _mesh_runtime.decline("epoch", "wrap_guard")
    return new_balances


def _rewards_literal_apply(ec, pairs) -> None:
    """Terminal mirror of the literal overflow fallback: commit the
    stages so far, then apply the SAME deltas through increase /
    decrease_balance so ``checked_add`` raises the structured error at
    the exact index (scalar parity). Unreachable under the _sync guards;
    kept so the contract survives a guard regression."""
    from .altair import helpers as hm

    _commit(ec)
    for rewards, penalties in pairs:
        for index in range(ec.n):
            hm.increase_balance(ec.state, index, int(rewards[index]))
            hm.decrease_balance(ec.state, index, int(penalties[index]))
    raise _PassComplete()


def _fused_fallback(reason: str) -> None:
    """A fused-route decline is NOT an engine fallback (the staged host
    kernels run and the pass stays columnar) — a separate counter, so a
    run can require zero ``epoch_vector.fallback.*`` while still seeing
    every fused routing decision."""
    metrics.counter(f"epoch_vector.fused_fallback.{reason}").inc()


def _fused_route(ec, leaking: bool) -> bool:
    """Run inactivity + rewards as ONE fused pass — mesh-sharded
    (parallel/epoch.py: the flag sums per shard, their psum, the element
    pass per shard) when the mesh owns the pass, else one launch of the
    fused epoch kernel (``ops/epoch.py``) when ``ops.install`` routed the
    sweeps device-ward. Returns True with ``ec.inact``/``ec.balances``
    rebound; False = run the staged kernels (bit-identical). The two
    declines are spec-preserving choices of route, never a hidden failure:
    a build or launch failure of a kernel raises."""
    if not ec.fused and ec.mesh is None:
        return False
    from .. import _device_flags
    from ..ops import epoch as _epoch
    from .altair.constants import (
        PARTICIPATION_FLAG_WEIGHTS,
        TIMELY_HEAD_FLAG_INDEX,
        WEIGHT_DENOMINATOR,
    )

    context = ec.context
    bias = int(context.inactivity_score_bias)
    # the staged host path clamps pathological eff*score products through
    # exact Python ints — a kernel cannot; post-update scores are bounded
    # by pre-update max + bias, so this guard covers the fused product
    if ec.n and int(ec.eff.max(initial=0)) * (
        int(ec.inact.max(initial=0)) + bias
    ) >= 1 << 64:
        _fused_fallback("u64_product")
        return False
    brpi, active_increments = _reward_scalars(ec)
    if ec.mesh is not None:
        out = ec.mesh.fused(
            ec.balances, ec.eff, ec.prev_part, ec.slashed, ec.active_prev,
            ec.eligible, ec.inact,
            increment=ec.increment,
            brpi=brpi,
            active_increments=active_increments,
            denominator=_penalty_denominator(ec),
            bias=bias,
            recovery_rate=int(context.inactivity_score_recovery_rate),
            weights=tuple(int(w) for w in PARTICIPATION_FLAG_WEIGHTS),
            weight_denominator=int(WEIGHT_DENOMINATOR),
            leaking=leaking,
            head_flag_index=int(TIMELY_HEAD_FLAG_INDEX),
            target_flag_index=_TIMELY_TARGET_FLAG_INDEX,
        )
        if out is None:
            # a wrap the guards should have made unreachable: the staged
            # path re-runs and its literal mirror raises the structured
            # error at the exact index
            from ..parallel import runtime as _mesh_runtime

            _mesh_runtime.decline("epoch", "wrap_guard")
            return False
        ec.inact, ec.balances = out
        metrics.counter("epoch_vector.fused.mesh").inc()
        return True
    scores, balances, wrapped = _epoch.fused_epoch_device(
        ec.balances, ec.eff, ec.prev_part, ec.slashed, ec.active_prev,
        ec.eligible, ec.inact,
        ec.increment,
        brpi,
        active_increments,
        _penalty_denominator(ec),
        bias,
        int(context.inactivity_score_recovery_rate),
        tuple(int(w) for w in PARTICIPATION_FLAG_WEIGHTS),
        int(WEIGHT_DENOMINATOR),
        leaking,
        int(TIMELY_HEAD_FLAG_INDEX),
        _TIMELY_TARGET_FLAG_INDEX,
        device=_device_flags.DEVICE,
    )
    if wrapped:
        # a wrap the guards should have made unreachable: the staged path
        # re-runs and its literal mirror raises the structured error at
        # the exact index
        _fused_fallback("wrap_guard")
        return False
    ec.inact = scores
    ec.balances = balances
    metrics.counter("epoch_vector.fused.device").inc()
    return True


def _inactivity_and_rewards(ec) -> None:
    """The altair-family inactivity + rewards stages: ONE fused launch on
    the device route, the staged host kernels otherwise — and when the
    fused route declines (every decline counted)."""
    if ec.cur == GENESIS_EPOCH:
        return
    from .phase0.epoch_processing import get_finality_delay

    leaking = (
        get_finality_delay(ec.state, ec.context)
        > ec.context.MIN_EPOCHS_TO_INACTIVITY_PENALTY
    )
    if _fused_route(ec, leaking):
        return
    _inactivity_updates(ec, leaking)
    _rewards_altair(ec, leaking)


# ---------------------------------------------------------------------------
# stages (phase0 family, and shared)
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
    if ec.cfg["activation"] == "activation_churn":
        limit = min(
            int(ec.context.max_per_epoch_activation_churn_limit), limit
        )
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
    """Materialize: ONE adopted bulk_store per scalar list (balances,
    inactivity scores) with exact changed indices, per-hit instrumented
    writes for the handful of changed validator epoch fields. After this
    the SSZ state and the (now clean, owned) column caches agree by
    construction."""
    np = ec.np
    state = ec.state
    if ec.balances is not ec.b_balances:
        ops_vector.adopt_list_column(
            state.balances,
            ec.balances,
            np.nonzero(ec.balances != ec.b_balances)[0],
            _U64_MAX,
        )
    if ec.inact is not None and ec.inact is not ec.b_inact:
        ops_vector.adopt_list_column(
            state.inactivity_scores,
            ec.inact,
            np.nonzero(ec.inact != ec.b_inact)[0],
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
    family = _FORK_CFG[fork]["family"]
    fused = False
    if _device_flags.sweeps_enabled(n):
        if family == "altair":
            # ops.install routed the sweeps device-ward: the pass stays
            # COLUMNAR and runs inactivity + rewards as the ONE fused
            # kernel launch — the per-stage device sweeps the literal
            # path would have launched collapse into a single upload
            fused = True
        else:
            # phase0 keeps the literal path's device hysteresis routing
            fallback("device_sweeps")
            return False
    if _np() is None:
        fallback("no_numpy")
        return False
    from .altair.constants import TIMELY_TARGET_FLAG_INDEX

    if TIMELY_TARGET_FLAG_INDEX != _TIMELY_TARGET_FLAG_INDEX:
        fallback("constants")
        return False
    ec = _sync(state, context, fork)
    if ec is None:
        return False
    ec.fused = fused
    if _env.mesh_requested():
        # the mesh runtime consult (parallel/runtime.py): an engaged runner
        # shards the inactivity and rewards sweeps; the runtime counts every
        # decline. The guard is a plain env read, so a mesh-off process
        # never imports the parallel package.
        from ..parallel import runtime as _mesh_runtime

        ec.mesh = _mesh_runtime.epoch_sweeps(n, family=family)
    from .phase0.epoch_processing import (
        process_eth1_data_reset,
        process_randao_mixes_reset,
        process_slashings_reset,
    )

    try:
        if family == "phase0":
            _justification_phase0(ec)
            _rewards_phase0(ec)
        else:
            _justification_altair(ec)
            _inactivity_and_rewards(ec)
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
    if ec.cfg["historical"] == "roots":
        from .phase0.epoch_processing import process_historical_roots_update

        process_historical_roots_update(state, context)
    else:
        from .capella.epoch_processing import process_historical_summaries_update

        process_historical_summaries_update(state, context)
    if family == "phase0":
        from .committees import drop_masks_memo

        # pending lists swap: this epoch's mask bundles are done
        drop_masks_memo(state)
        state.previous_epoch_attestations = state.current_epoch_attestations
        state.current_epoch_attestations = []
    else:
        state.previous_epoch_participation = state.current_epoch_participation
        state.current_epoch_participation = [0] * n
        ops_vector.install_zero_column(state.current_epoch_participation, n, 0xFF)
        next_epoch = ec.cur + 1
        if next_epoch % int(context.EPOCHS_PER_SYNC_COMMITTEE_PERIOD) == 0:
            # the sampling sweep reads the committed registry; seed its
            # active-index tuple from the committed columns so the rare
            # boundary stays walk-free too
            np = ec.np
            mask = (ec.act <= np.uint64(next_epoch)) & (
                np.uint64(next_epoch) < ec.exit
            )
            _seed_active_indices(ec, next_epoch, mask)
            from .altair.epoch_processing import process_sync_committee_updates

            process_sync_committee_updates(state, context)
    metrics.counter("epoch_vector.epochs").inc()
    return True
