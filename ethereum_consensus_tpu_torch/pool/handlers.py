"""Pool data plane: the Beacon-API WRITE surface.

``PoolDataPlane`` mounts beside the read plane (``serving/``) on the
introspection server (longest-prefix app routing, ``telemetry/server.py``)
and owns:

* ``POST /eth/v1/beacon/pool/attestations`` — batch admission through
  the ``AdmissionEngine``: the whole request admits, the partial window
  flushes, and every ticket settles before the response, so rejections
  come back in the standard per-index failure envelope.
* ``POST /eth/v1/beacon/pool/{voluntary_exits,attester_slashings,
  proposer_slashings,bls_to_execution_changes}`` — singleton-op
  admission, same settle-before-respond contract.
* the matching ``GET`` pool views — held ops in canonical order, in the
  SSZ JSON wire format, bit-identical to the scalar-twin pool's.
* ``POST /eth/v2/beacon/blocks`` (and v1) — block publication into the
  chain pipeline via the injected ``submit`` callable; a rejected block
  surfaces its structured error in the 400 body.
* ``GET /pool`` — introspection: held-op counts, admission window
  state, rejection counters by reason.

JSON decode errors never raise out: an undecodable item is a
``malformed`` rejection like any other, carried per index.

Reference parity: ethereum_consensus_tpu/pool/handlers.py.
"""

from __future__ import annotations

from ..telemetry import metrics as _metrics
from .admission import REASONS, _note_rejection

__all__ = ["PoolDataPlane"]


class PoolDataPlane:
    """Mountable write plane over an ``AdmissionEngine`` (which owns the
    pool + head store). ``submit``, when given, receives decoded
    ``SignedBeaconBlock`` containers from block publication."""

    prefix = "/eth/v1/beacon/pool/"
    prefixes = (
        "/eth/v1/beacon/pool/",
        "/eth/v1/beacon/blocks",
        "/eth/v2/beacon/blocks",
        "/pool",
    )

    ROUTES = (
        "GET  /eth/v1/beacon/pool/attestations?slot=&committee_index=",
        "POST /eth/v1/beacon/pool/attestations",
        "GET  /eth/v1/beacon/pool/voluntary_exits",
        "POST /eth/v1/beacon/pool/voluntary_exits",
        "GET  /eth/v1/beacon/pool/attester_slashings",
        "POST /eth/v1/beacon/pool/attester_slashings",
        "GET  /eth/v1/beacon/pool/proposer_slashings",
        "POST /eth/v1/beacon/pool/proposer_slashings",
        "GET  /eth/v1/beacon/pool/bls_to_execution_changes",
        "POST /eth/v1/beacon/pool/bls_to_execution_changes",
        "POST /eth/v1/beacon/blocks",
        "POST /eth/v2/beacon/blocks",
        "GET  /pool",
    )

    def __init__(self, engine, submit=None):
        self.engine = engine
        self.submit = submit

    # -- plumbing ------------------------------------------------------------
    @property
    def pool(self):
        return self.engine.pool

    def _param(self, params: dict, key: str):
        values = params.get(key)
        return values[0] if values else None

    def _ns(self):
        """The head fork's container namespace (the wire types)."""
        snap = self.engine.store.head
        if snap is None:
            return None
        return self.engine._builder(snap.fork)

    def handle(self, method: str, path: str, params: dict, body):
        """(status, document); never raises — server contract."""
        try:
            return self._dispatch(method, path, params, body)
        except Exception as exc:  # noqa: BLE001 — a client must get a reply
            _metrics.counter("pool.handler_errors").inc()
            return 500, {"code": 500,
                         "message": f"{type(exc).__name__}: {exc}"}

    def _dispatch(self, method: str, path: str, params: dict, body):
        if path == "/pool" and method == "GET":
            return self._introspect()
        if path in ("/eth/v1/beacon/blocks", "/eth/v2/beacon/blocks"):
            if method != "POST":
                return 404, {"code": 404,
                             "message": f"no pool route {method} {path}"}
            return self._publish_block(body)
        leaf = path[len(self.prefix):] if path.startswith(self.prefix) else None
        handlers = {
            "attestations": (self._get_attestations,
                             self._post_attestations),
            "voluntary_exits": (
                lambda p: self._get_ops(self.pool.voluntary_exits),
                lambda b: self._post_ops(
                    b, "VoluntaryExit", self.engine.admit_voluntary_exit,
                    signed=True,
                ),
            ),
            "attester_slashings": (
                lambda p: self._get_ops(self.pool.attester_slashings),
                lambda b: self._post_ops(
                    b, "AttesterSlashing",
                    self.engine.admit_attester_slashing,
                ),
            ),
            "proposer_slashings": (
                lambda p: self._get_ops(self.pool.proposer_slashings),
                lambda b: self._post_ops(
                    b, "ProposerSlashing",
                    self.engine.admit_proposer_slashing,
                ),
            ),
            "bls_to_execution_changes": (
                lambda p: self._get_ops(self.pool.bls_changes),
                lambda b: self._post_ops(
                    b, "SignedBlsToExecutionChange",
                    self.engine.admit_bls_change,
                ),
            ),
        }
        if leaf in handlers:
            get_fn, post_fn = handlers[leaf]
            if method == "GET":
                return get_fn(params)
            if method == "POST":
                return post_fn(body)
        return 404, {"code": 404, "message": f"no pool route {method} {path}"}

    # -- attestations --------------------------------------------------------
    def _get_attestations(self, params: dict):
        slot = self._param(params, "slot")
        index = self._param(params, "committee_index")
        atts = self.pool.attestations_view(
            slot=None if slot is None else int(slot),
            committee_index=None if index is None else int(index),
        )
        return 200, {
            "data": [type(a).to_json(a) for a in atts],
        }

    def _post_attestations(self, body):
        if not isinstance(body, list):
            return 400, {"code": 400,
                         "message": "expected a JSON list of attestations"}
        ns = self._ns()
        tickets: list = []
        decoded: list = []
        for i, doc in enumerate(body):
            if ns is None:
                tickets.append((i, None, "no_head"))
                _note_rejection("no_head")
                continue
            try:
                att = ns.Attestation.from_json(doc)
            except Exception:  # noqa: BLE001 — malformed SSZ JSON
                tickets.append((i, None, "malformed"))
                _note_rejection("malformed")
                continue
            decoded.append((i, att))
        # the whole request admits as ONE batch — one admission span,
        # one window fill, at most one flush dispatch per filled window
        for (i, _att), ticket in zip(
            decoded,
            self.engine.admit_attestation_batch(
                [att for _, att in decoded]
            ),
        ):
            tickets.append((i, ticket, None))
        self.engine.settle()
        tickets.sort(key=lambda t: t[0])
        return self._admission_response(tickets)

    # -- singleton ops -------------------------------------------------------
    def _get_ops(self, reader):
        ops = reader()
        return 200, {"data": [type(op).to_json(op) for op in ops]}

    def _post_ops(self, body, type_name: str, admit, signed: bool = False):
        """Admit one op (or a list — the BLS-changes shape); settle;
        respond. ``type_name`` resolves on the head fork's namespace,
        with the ``Signed`` wrapper applied when the wire type is the
        signed envelope."""
        ns = self._ns()
        if ns is None:
            _note_rejection("no_head")
            return 503, {"code": 503, "message": "no head to validate against"}
        wire_name = f"Signed{type_name}" if signed else type_name
        wire_type = getattr(ns, wire_name, None)
        if wire_type is None:
            return 400, {
                "code": 400,
                "message": f"{wire_name} is not a {self._head_fork()} type",
            }
        docs = body if isinstance(body, list) else [body]
        tickets = []
        for i, doc in enumerate(docs):
            try:
                op = wire_type.from_json(doc)
            except Exception:  # noqa: BLE001 — malformed SSZ JSON
                tickets.append((i, None, "malformed"))
                _note_rejection("malformed")
                continue
            tickets.append((i, admit(op), None))
        self.engine.settle()
        return self._admission_response(tickets)

    def _head_fork(self):
        snap = self.engine.store.head
        return snap.fork if snap is not None else "unknown"

    def _admission_response(self, tickets):
        failures = []
        for index, ticket, early_reason in tickets:
            reason = early_reason
            if ticket is not None and ticket.status == "rejected":
                reason = ticket.reason
            if reason is not None:
                failures.append({"index": str(index), "message": reason})
        admitted = len(tickets) - len(failures)
        if failures:
            return 400, {
                "code": 400,
                "message": "one or more messages failed admission",
                "failures": failures,
                "data": {"admitted": str(admitted)},
            }
        return 200, {"data": {"admitted": str(admitted)}}

    # -- block publication ---------------------------------------------------
    def _publish_block(self, body):
        if self.submit is None:
            return 501, {"code": 501,
                         "message": "no block submission sink mounted"}
        if not isinstance(body, dict):
            return 400, {"code": 400,
                         "message": "expected a signed block document"}
        snap = self.engine.store.head
        forks = []
        if snap is not None:
            forks.append(snap.fork)
        forks.extend(
            f for f in ("electra", "deneb", "capella", "bellatrix",
                        "altair", "phase0")
            if f not in forks
        )
        block = None
        for fork in forks:
            ns = self.engine._builder(fork)
            try:
                block = ns.SignedBeaconBlock.from_json(body)
                break
            except Exception:  # noqa: BLE001 — try the next fork's shape
                continue
        if block is None:
            _note_rejection("malformed")
            return 400, {"code": 400,
                         "message": "block does not decode under any fork"}
        from ..error import Error

        try:
            self.submit(block)
        except Error as exc:
            _metrics.counter("pool.blocks_rejected").inc()
            return 400, {
                "code": 400,
                "message": f"{type(exc).__name__}: {exc}",
            }
        _metrics.counter("pool.blocks_published").inc()
        return 200, {"data": {
            "slot": str(int(block.message.slot)),
        }}

    # -- introspection -------------------------------------------------------
    def _introspect(self):
        rejected = {}
        for reason in REASONS:
            value = _metrics.counter(f"pool.rejected.{reason}").value()
            if value:
                rejected[reason] = value
        counts = self.pool.counts()
        doc = {
            "counts": counts,
            "admission": self.engine.snapshot(),
            "rejected": rejected,
            "flushes": _metrics.counter("pool.flushes").value(),
            "fused_groups": _metrics.counter("pool.fused_groups").value(),
            "blocks_produced": _metrics.counter(
                "pool.blocks_produced"
            ).value(),
            "blocks_published": _metrics.counter(
                "pool.blocks_published"
            ).value(),
        }
        return 200, doc
