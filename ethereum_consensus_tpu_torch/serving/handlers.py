"""Beacon-API read handlers — the data plane mounted on the introspection
server (telemetry/server.py).

``BeaconDataPlane`` is a tiny WSGI-shaped app the telemetry server
routes ``/eth/...`` requests into: ``handle(method, path, params, body)
→ (status, document)``. Every request resolves exactly ONE ``HeadStore``
snapshot at entry and serves entirely from it — the snapshot-isolation
contract — and every batched registry
read is one columnar gather (``serving/views.py``) with the scalar
oracle (``serving/oracle.py``) as fallback and differential twin.

Wire format: the standard Beacon-API envelopes (``data`` payloads,
string-encoded integers, 0x-hex bytes); responses additionally
carry ``snapshot_root`` (the served snapshot's state root) so a
reader can pin each response to the exact committed state it came from.

Endpoint catalog: see ``ROUTES`` below.

Reference parity: ethereum_consensus_tpu/serving/handlers.py (``_dispatch``
:123-182, ``_state_proof`` :416).
"""

from __future__ import annotations

import time

from ..telemetry import metrics as _metrics
from . import oracle, views

__all__ = ["BeaconDataPlane"]


def _error(status: int, message: str):
    _metrics.counter("serving.errors").inc()
    return status, {"code": status, "message": message}


class BeaconDataPlane:
    """The mountable read plane over a ``HeadStore``.

    Stateless beyond the store reference: all request-scoped work lives
    on the resolved snapshot (bundle, memoized documents), so concurrent
    handler threads share nothing mutable here."""

    prefix = "/eth/"

    ROUTES = (
        "GET  /eth/v1/beacon/genesis",
        "GET  /eth/v1/beacon/states/{state_id}/root",
        "GET  /eth/v1/beacon/states/{state_id}/fork",
        "GET  /eth/v1/beacon/states/{state_id}/finality_checkpoints",
        "GET  /eth/v1/beacon/states/{state_id}/randao?epoch=",
        "GET  /eth/v1/beacon/states/{state_id}/validators?id=&status=",
        "GET  /eth/v1/beacon/states/{state_id}/validators/{validator_id}",
        "GET  /eth/v1/beacon/states/{state_id}/validator_balances?id=",
        "GET  /eth/v1/beacon/states/{state_id}/committees?epoch=&index=&slot=",
        "GET  /eth/v1/beacon/states/{state_id}/sync_committees?epoch=",
        "GET  /eth/v1/beacon/states/{state_id}/epoch_rewards",
        "GET  /eth/v1/beacon/states/{state_id}/proof?gindex=",
        "GET  /eth/v1/beacon/light_client/bootstrap/{block_root}",
        "GET  /eth/v1/beacon/light_client/updates?start_period=&count=",
        "GET  /eth/v1/beacon/light_client/finality_update",
        "GET  /eth/v1/beacon/light_client/optimistic_update",
        "POST /eth/v1/validator/duties/attester/{epoch}",
        "GET  /eth/v1/validator/duties/proposer/{epoch}",
    )

    def __init__(self, store):
        self.store = store

    # -- plumbing ------------------------------------------------------------
    def _param(self, params: dict, key: str):
        values = params.get(key)
        return values[0] if values else None

    def _list_param(self, params: dict, key: str) -> list:
        out: list = []
        for chunk in params.get(key, ()):
            out.extend(v for v in chunk.split(",") if v)
        return out

    def _resolve(self, state_id: str):
        snap = self.store.resolve(state_id)
        if snap is None:
            raise _NotFound(
                f"state {state_id!r} is not retained "
                f"({len(self.store)} snapshots held)"
            )
        return snap

    def _envelope(self, snap, data, extra=None) -> dict:
        doc = {
            "execution_optimistic": False,
            "finalized": False,
            "snapshot_root": snap.root_hex(),
            "data": data,
        }
        if extra:
            doc.update(extra)
        return doc

    # -- dispatch ------------------------------------------------------------
    def handle(self, method: str, path: str, params: dict, body):
        """(status, JSON document) for one request; never raises — the
        server thread must always get a response to write."""
        t0 = time.perf_counter()
        route = "?"
        try:
            route, response = self._dispatch(method, path, params, body)
            return response
        except _NotFound as exc:
            return _error(404, str(exc))
        except (oracle.BadRequest, ValueError) as exc:
            return _error(400, str(exc))
        except Exception as exc:  # noqa: BLE001 — a reader must get a reply
            return _error(500, f"{type(exc).__name__}: {exc}")
        finally:
            _metrics.counter("serving.requests").inc()
            _metrics.counter(f"serving.requests.{route}").inc()
            _metrics.histogram("serving.request_s").observe(
                time.perf_counter() - t0
            )

    def _dispatch(self, method: str, path: str, params: dict, body):
        parts = [p for p in path.split("/") if p]
        # parts[0] == "eth" guaranteed by the mount prefix
        if parts[1:3] == ["v1", "beacon"]:
            if parts[3:] == ["genesis"] and method == "GET":
                return "genesis", self._genesis()
            if len(parts) >= 6 and parts[3] == "states":
                return self._dispatch_state(method, parts[4], parts[5:], params)
            if parts[3] == "light_client" and method == "GET":
                return self._dispatch_light_client(parts[4:], params)
        if parts[1:4] == ["v1", "validator", "duties"] and len(parts) == 6:
            if parts[4] == "attester" and method == "POST":
                return "duties_attester", self._attester_duties(
                    int(parts[5]), body
                )
            if parts[4] == "proposer" and method == "GET":
                return "duties_proposer", self._proposer_duties(int(parts[5]))
        raise _NotFound(f"no data-plane route {method} {path}")

    def _dispatch_state(self, method, state_id, rest, params):
        if method != "GET":
            raise _NotFound(f"no data-plane route {method} for states")
        if rest == ["root"]:
            return "root", self._root(state_id)
        if rest == ["fork"]:
            return "fork", self._fork(state_id)
        if rest == ["finality_checkpoints"]:
            return "finality", self._finality(state_id)
        if rest == ["randao"]:
            return "randao", self._randao(state_id, params)
        if rest == ["validators"]:
            return "validators", self._validators(state_id, params)
        if len(rest) == 2 and rest[0] == "validators":
            return "validator", self._one_validator(state_id, rest[1])
        if rest == ["validator_balances"]:
            return "balances", self._balances(state_id, params)
        if rest == ["committees"]:
            return "committees", self._committees(state_id, params)
        if rest == ["sync_committees"]:
            return "sync_committees", self._sync_committees(state_id, params)
        if rest == ["epoch_rewards"]:
            return "rewards", self._epoch_rewards(state_id)
        if rest == ["proof"]:
            return "proof", self._state_proof(state_id, params)
        raise _NotFound(f"no data-plane route GET states/{'/'.join(rest)}")

    def _dispatch_light_client(self, rest, params):
        if len(rest) == 2 and rest[0] == "bootstrap":
            return "lc_bootstrap", self._lc_bootstrap(rest[1])
        if rest == ["updates"]:
            return "lc_updates", self._lc_updates(params)
        if rest == ["finality_update"]:
            return "lc_finality", self._lc_finality_update()
        if rest == ["optimistic_update"]:
            return "lc_optimistic", self._lc_optimistic_update()
        raise _NotFound(
            f"no data-plane route GET light_client/{'/'.join(rest)}"
        )

    # -- scalar-metadata endpoints -------------------------------------------
    def _genesis(self):
        snap = self._resolve("head")
        state = snap.raw
        return 200, self._envelope(
            snap,
            {
                "genesis_time": str(int(state.genesis_time)),
                "genesis_validators_root": "0x"
                + bytes(state.genesis_validators_root).hex(),
                "genesis_fork_version": "0x"
                + bytes(snap.context.genesis_fork_version).hex(),
            },
        )

    def _root(self, state_id):
        snap = self._resolve(state_id)
        return 200, self._envelope(snap, {"root": snap.root_hex()})

    def _fork(self, state_id):
        snap = self._resolve(state_id)
        fork = snap.raw.fork
        return 200, self._envelope(snap, type(fork).to_json(fork))

    def _finality(self, state_id):
        snap = self._resolve(state_id)
        state = snap.raw
        return 200, self._envelope(
            snap,
            {
                name: type(cp).to_json(cp)
                for name, cp in (
                    ("previous_justified", state.previous_justified_checkpoint),
                    ("current_justified", state.current_justified_checkpoint),
                    ("finalized", state.finalized_checkpoint),
                )
            },
        )

    def _randao(self, state_id, params):
        snap = self._resolve(state_id)
        from ..models.phase0.helpers import get_randao_mix

        epoch_raw = self._param(params, "epoch")
        epoch = (
            int(epoch_raw)
            if epoch_raw is not None
            else oracle.current_epoch(snap.raw, snap.context)
        )
        mix = snap.memo(
            ("randao", epoch), lambda: get_randao_mix(snap.raw, epoch)
        )
        return 200, self._envelope(snap, {"randao": "0x" + bytes(mix).hex()})

    # -- columnar registry endpoints -----------------------------------------
    def _validators(self, state_id, params):
        snap = self._resolve(state_id)
        ids = self._list_param(params, "id")
        statuses = self._list_param(params, "status")
        allowed = views.parse_statuses(statuses)
        indices = (
            oracle.resolve_validator_ids(snap.raw, ids) if ids else None
        )
        bundle = views.snapshot_bundle(snap)
        if bundle is None:
            _metrics.counter("serving.fallback").inc()
            rows = oracle.validators_data(
                snap.raw,
                snap.context,
                indices,
                None
                if allowed is None
                else {views.STATUS_NAMES[c] for c in allowed},
            )
        else:
            idx, balances, codes = views.resolve_validators(
                bundle, indices, allowed
            )
            vals = snap.raw.validators
            rows = [
                {
                    "index": str(i),
                    "balance": str(int(b)),
                    "status": views.STATUS_NAMES[c],
                    "validator": type(vals[i]).to_json(vals[i]),
                }
                for i, b, c in zip(idx.tolist(), balances.tolist(), codes.tolist())
            ]
        return 200, self._envelope(snap, rows)

    def _one_validator(self, state_id, validator_id):
        snap = self._resolve(state_id)
        indices = oracle.resolve_validator_ids(snap.raw, [validator_id])
        if not indices:
            raise _NotFound(f"validator {validator_id!r} not found")
        index = indices[0]
        bundle = views.snapshot_bundle(snap)
        if bundle is None:
            _metrics.counter("serving.fallback").inc()
            row = oracle.validators_data(snap.raw, snap.context, [index])[0]
        else:
            idx, balances, codes = views.resolve_validators(bundle, [index])
            validator = snap.raw.validators[index]
            row = {
                "index": str(index),
                "balance": str(int(balances[0])),
                "status": views.STATUS_NAMES[int(codes[0])],
                "validator": type(validator).to_json(validator),
            }
        return 200, self._envelope(snap, row)

    def _balances(self, state_id, params):
        snap = self._resolve(state_id)
        ids = self._list_param(params, "id")
        indices = (
            oracle.resolve_validator_ids(snap.raw, ids) if ids else None
        )
        bundle = views.snapshot_bundle(snap)
        if bundle is None:
            _metrics.counter("serving.fallback").inc()
            rows = oracle.balances_data(snap.raw, indices)
        else:
            if indices is None:
                balances = bundle["balances"]
                index_list = range(balances.shape[0])
                _metrics.counter("serving.gathers").inc()
            else:
                gathered = views.gather(bundle, indices, ("balances",))
                balances = gathered["balances"]
                index_list = indices
            rows = [
                {"index": str(i), "balance": str(int(b))}
                for i, b in zip(index_list, balances.tolist())
            ]
        return 200, self._envelope(snap, rows)

    # -- committee machinery endpoints ---------------------------------------
    def _committees(self, state_id, params):
        snap = self._resolve(state_id)
        epoch = self._param(params, "epoch")
        index = self._param(params, "index")
        slot = self._param(params, "slot")
        key = ("committees", epoch, index, slot)
        rows = snap.memo(
            key,
            lambda: oracle.committees_data(
                snap.raw,
                snap.context,
                epoch=None if epoch is None else int(epoch),
                index=None if index is None else int(index),
                slot=None if slot is None else int(slot),
            ),
        )
        return 200, self._envelope(snap, rows)

    def _sync_committees(self, state_id, params):
        snap = self._resolve(state_id)
        epoch = self._param(params, "epoch")
        doc = snap.memo(
            ("sync_committees", epoch),
            lambda: oracle.sync_committees_data(
                snap.raw,
                snap.context,
                epoch=None if epoch is None else int(epoch),
            ),
        )
        return 200, self._envelope(snap, doc)

    def _attester_duties(self, epoch: int, body):
        if not isinstance(body, list):
            raise oracle.BadRequest(
                "attester duties take a JSON list of validator indices"
            )
        snap = self._resolve("head")
        indices = oracle.resolve_validator_ids(
            snap.raw, [str(v) for v in body]
        )
        duty_map = snap.memo(
            ("duty_map", epoch),
            lambda: oracle.attester_duty_map(snap.raw, snap.context, epoch),
        )
        rows = oracle.attester_duties_data(snap.raw, duty_map, indices)
        dep = snap.memo(
            ("dependent_root", "attester", epoch),
            lambda: oracle.dependent_root(
                snap.raw, snap.context, epoch, "attester",
                head_root=snap.block_root,
            ),
        )
        return 200, self._envelope(
            snap, rows, extra={"dependent_root": "0x" + dep.hex()}
        )

    def _proposer_duties(self, epoch: int):
        snap = self._resolve("head")
        rows = snap.memo(
            ("proposer_duties", epoch),
            lambda: oracle.proposer_duties_data(snap.raw, snap.context, epoch),
        )
        dep = snap.memo(
            ("dependent_root", "proposer", epoch),
            lambda: oracle.dependent_root(
                snap.raw, snap.context, epoch, "proposer",
                head_root=snap.block_root,
            ),
        )
        return 200, self._envelope(
            snap, rows, extra={"dependent_root": "0x" + dep.hex()}
        )

    def _epoch_rewards(self, state_id):
        snap = self._resolve(state_id)

        def build():
            doc = views.rewards_summary_columnar(snap)
            if doc is None:
                _metrics.counter("serving.fallback").inc()
                doc = oracle.rewards_summary_data(snap.raw, snap.context)
            return doc

        return 200, self._envelope(snap, snap.memo(("rewards",), build))

    # -- proof & light-client plane -------------------------------------------
    def _proof_ctx(self, snap):
        """One warm walker per snapshot: the settle inside ProofContext is
        a no-op once the snapshot's root has been computed, and the memo
        makes every proof request off this snapshot share the lazily
        built layer providers."""
        from ..proofs import ProofContext

        return snap.memo(
            ("proof_ctx",), lambda: ProofContext(type(snap.raw), snap.raw)
        )

    def _state_proof(self, state_id, params):
        snap = self._resolve(state_id)
        raw = self._list_param(params, "gindex")
        if not raw:
            raise oracle.BadRequest("proof requires at least one gindex=")
        try:
            gindices = sorted({int(g) for g in raw})
        except ValueError:
            raise oracle.BadRequest(f"gindex must be integers, got {raw!r}")
        if any(g < 1 for g in gindices):
            raise oracle.BadRequest("gindex must be >= 1")

        # fetched OUTSIDE the proof-document memo below: snap.memo's
        # lock is not reentrant, so the nested ("proof_ctx",) memo must
        # resolve first, not from inside build()
        ctx = self._proof_ctx(snap)

        def build():
            if len(gindices) == 1:
                gi = gindices[0]
                return {
                    "gindex": str(gi),
                    "leaf": "0x" + ctx.node_at(gi).hex(),
                    "proof": ["0x" + node.hex() for node in ctx.proof(gi)],
                }
            from ..proofs import extract_multiproof

            mp = extract_multiproof(ctx, gindices=gindices)
            return {
                "gindices": [str(g) for g in mp.gindices],
                "leaves": ["0x" + leaf.hex() for leaf in mp.leaves],
                "proof": ["0x" + node.hex() for node in mp.proof],
            }

        doc = snap.memo(("proof", tuple(gindices)), build)
        return 200, self._envelope(snap, doc)

    def _lc_bootstrap(self, block_root):
        from ..proofs import light_client as lc

        snap = self._resolve(block_root)
        doc, fork = snap.memo(
            ("lc_bootstrap",), lambda: lc.light_client_bootstrap(snap)
        )
        return 200, self._envelope(
            snap, type(doc).to_json(doc), extra={"version": fork}
        )

    def _lc_updates(self, params):
        from ..proofs import light_client as lc

        start = self._param(params, "start_period")
        count = self._param(params, "count")
        if start is None or count is None:
            raise oracle.BadRequest(
                "updates requires start_period= and count="
            )
        pairs = lc.light_client_updates(self.store, int(start), int(count))
        # spec wire shape: a bare list of {version, data} — no envelope
        return 200, [
            {"version": fork, "data": type(doc).to_json(doc)}
            for doc, fork in pairs
        ]

    def _lc_finality_update(self):
        from ..proofs import light_client as lc

        snap = self._resolve("head")
        try:
            doc, fork = snap.memo(
                ("lc_finality",),
                lambda: lc.light_client_finality_update(self.store, snap),
            )
        except LookupError as exc:
            raise _NotFound(str(exc))
        return 200, self._envelope(
            snap, type(doc).to_json(doc), extra={"version": fork}
        )

    def _lc_optimistic_update(self):
        from ..proofs import light_client as lc

        snap = self._resolve("head")
        try:
            doc, fork = snap.memo(
                ("lc_optimistic",),
                lambda: lc.light_client_optimistic_update(self.store, snap),
            )
        except LookupError as exc:
            raise _NotFound(str(exc))
        return 200, self._envelope(
            snap, type(doc).to_json(doc), extra={"version": fork}
        )


class _NotFound(Exception):
    """Maps to HTTP 404 in ``handle``."""
