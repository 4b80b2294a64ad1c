"""Live introspection server: /metrics, /healthz, /blocks, /events,
/device.

A stdlib-only threaded HTTP server over the telemetry substrate, and the
mount point of the Beacon-API read plane (``serving/``):

* ``/metrics``  — the WHOLE metrics registry in Prometheus text
  exposition format 0.0.4: counters and gauges verbatim, histograms as
  summaries (``{quantile="..."}`` gauges from the bounded reservoir +
  ``_sum``/``_count``) with ``_min``/``_max`` companion gauges. Strict
  format 0.0.4 — no OpenMetrics constructs, so any classic scraper
  parses every line.
* ``/healthz``  — pipeline liveness: ``ok`` / ``degraded`` (the latched
  ``pipeline.degraded`` gauge) / ``broken`` (the latched
  ``pipeline.broken`` gauge, with the stuck window's seq + slots from
  the flight recorder's ``broken`` event).
* ``/blocks``   — recent ``BlockLineage`` records as JSON; filter by
  ``?outcome=``, ``?min_slot=``/``?max_slot=``, rank by
  ``?worst=<latency field>``, cap with ``?n=``.
* ``/events``   — Server-Sent Events off the pipeline commit hook:
  ``head`` / ``commit`` / ``rollback`` / ``broken`` (add ``block`` for
  full lineage records with ``?kinds=head,block``). Commit order on the
  wire IS chain order — the submitting thread emits. Idle streams carry
  a ``: ping`` keepalive comment every ``sse_keepalive_s`` (default
  15 s) so proxies and load balancers don't reap quiet subscribers.
* ``/device``   — the device execution observatory's ledgers
  (telemetry/device.py): kernel-library loads, launches, per-site
  host<->device transfer aggregates and the device-vs-host routing
  journal. ``?n=`` caps the journal tails.
* ``/memory``   — the memory & bandwidth observatory's ledgers
  (telemetry/memory.py): the resident-set census with its ``worst``
  attribution table, the phase RSS ledger, and the per-site bulk-copy
  byte counters. ``?n=`` caps the worst table. The census probes run
  at request time — a scrape IS a census.
* ``/trace``    — the causal trace plane's read side. ``?id=<trace_id>``
  assembles one trace into its causal tree: the span tree (with
  cross-lane flow edges and a ``connected`` verdict), the flight
  lineage records settled under that trace, and the device span-plane
  evidence (``device.*`` route/transfer events) that landed inside the
  trace's time window. Bare ``/trace`` returns the worst-N slow-trace
  ring, the span recorder's audit (span/trace/orphan/drop counts), and
  every histogram's worst-N exemplar table — the JSON home of exemplar
  evidence (``/metrics`` stays pure text format 0.0.4: the OpenMetrics
  ``# {...}`` exemplar appendage would read as a malformed timestamp to
  classic parsers and fail the whole scrape, and even OpenMetrics only
  allows exemplars on counters/histogram buckets, not the summary
  quantiles we render). Trace ids come from the ``/trace`` exemplar
  tables and the lineage records on ``/blocks``/``/events``.

``/metrics`` additionally carries a standard ``build_info`` gauge (git
sha, torch/numpy versions, torch's CUDA version and the backend as labels,
value 1) so every scrape is self-describing.

Concurrency model: the accept loop runs on a
single-worker ``ThreadPoolExecutor`` (the repo's sanctioned way to own a
background worker); per-request threads come from
``ThreadingHTTPServer`` with ``daemon_threads`` set; every
``IntrospectionServer`` state write holds its instance lock; SSE
fan-out rides the ``CommitHook``'s lock-free tuple snapshot with one
bounded ``queue.Queue`` per client (a slow client drops events rather
than backpressuring the pipeline — counted in
``flight.sse_dropped_events``).

Zero overhead when off: nothing here is imported by the pipeline; the
engine's only coupling is the ``flight.HOOK.active`` bool.

Reference parity: ethereum_consensus_tpu/telemetry/server.py
(``IntrospectionServer`` :647); ``build_info`` names torch and CUDA where
the reference names jax and its x64 flag.
"""

from __future__ import annotations

import json
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from . import device as _device
from . import flight as _flight
from . import memory as _memory
from . import metrics as _metrics
from . import spans as _spans

__all__ = [
    "IntrospectionServer",
    "render_prometheus",
    "prometheus_name",
    "escape_label_value",
    "health_view",
    "build_info_labels",
    "build_info_line",
]

_QUANTILES = (0.5, 0.9, 0.99)
_SSE_DEFAULT_KINDS = ("head", "commit", "rollback", "broken")
DEFAULT_SSE_KEEPALIVE_S = 15.0


# ---------------------------------------------------------------------------
# Prometheus text exposition (format 0.0.4)
# ---------------------------------------------------------------------------


def prometheus_name(name: str) -> str:
    """The registry's dotted name as a valid Prometheus metric name:
    ``[a-zA-Z_:][a-zA-Z0-9_:]*`` — dots (and anything else outside the
    alphabet) become underscores, a leading digit gets a prefix."""
    out = [
        ch if (ch.isascii() and (ch.isalnum() or ch in "_:")) else "_"
        for ch in name
    ]
    rendered = "".join(out) or "_"
    if rendered[0].isdigit():
        rendered = "_" + rendered
    return rendered


def escape_label_value(value: str) -> str:
    """Label-value escaping per the text format: backslash, double
    quote, and newline."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def _read_git_sha() -> str:
    """The checkout's HEAD commit, read straight from .git (no
    subprocess, no git dependency); "unknown" outside a checkout."""
    import os

    repo = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    try:
        with open(os.path.join(repo, ".git", "HEAD")) as f:
            head = f.read().strip()
        if head.startswith("ref: "):
            ref = head[len("ref: "):]
            with open(os.path.join(repo, ".git", ref)) as f:
                return f.read().strip()[:12]
        return head[:12]
    except OSError:
        return "unknown"


def _dist_version(name: str) -> str:
    """Installed version without importing the package (a /metrics
    scrape must never trigger a cold import)."""
    import sys

    mod = sys.modules.get(name)
    version = getattr(mod, "__version__", None)
    if version:
        return str(version)
    try:
        from importlib import metadata

        return metadata.version(name)
    except Exception:  # noqa: BLE001 — absent dependency
        return "unknown"


def build_info_labels() -> dict:
    """The ``build_info`` label set: git sha, torch/numpy versions, the
    CUDA version torch was built for, and the backend ("cuda" where a card
    is visible, else "cpu"). CUDA and the backend read ``uninitialized``
    while torch is not imported (never importing it from here)."""
    import sys

    torch_mod = sys.modules.get("torch")
    cuda = "uninitialized"
    backend = "uninitialized"
    if torch_mod is not None:
        cuda = str(torch_mod.version.cuda or "none")
        backend = "cuda" if torch_mod.cuda.is_available() else "cpu"
    return {
        "git_sha": _read_git_sha(),
        "torch": _dist_version("torch"),
        "numpy": _dist_version("numpy"),
        "cuda": cuda,
        "backend": backend,
    }


def build_info_line() -> str:
    labels = ",".join(
        f'{key}="{escape_label_value(value)}"'
        for key, value in sorted(build_info_labels().items())
    )
    return f"build_info{{{labels}}} 1"


def render_prometheus(metric_objects=None) -> str:
    """The registry (or an explicit metric-object list — the golden
    test's seam) as one exposition document, prefixed — on the
    default registry walk only — by the standard ``build_info`` gauge.
    Counters/gauges render verbatim; a ``Histogram`` renders as a
    summary — reservoir-derived ``{quantile="0.5|0.9|0.99"}`` samples
    plus exact ``_sum``/``_count`` — with ``_min``/``_max`` companion
    gauges.

    Deliberately NO exemplars here: the document is served as
    ``text/plain; version=0.0.4``, whose parser reads the OpenMetrics
    ``# {...}`` appendage as a malformed timestamp and rejects the
    line — failing the ENTIRE scrape whenever any histogram holds an
    exemplar. Even under negotiated OpenMetrics, exemplars are only
    legal on counters and histogram buckets, never on the summary
    quantiles rendered here. Exemplar evidence lives on the JSON side:
    bare ``/trace`` serves every histogram's worst-N table."""
    lines: list = []
    if metric_objects is None:
        metric_objects = _metrics.registered_metrics()
        lines.append(
            "# HELP build_info repo/toolchain identity of this process"
        )
        lines.append("# TYPE build_info gauge")
        lines.append(build_info_line())
    for metric in metric_objects:
        name = prometheus_name(metric.name)
        lines.append(f"# HELP {name} {escape_help(metric.name)}")
        if isinstance(metric, _metrics.Counter):
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name} {_fmt(metric.value())}")
        elif isinstance(metric, _metrics.Gauge):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {_fmt(metric.value())}")
        elif isinstance(metric, _metrics.Histogram):
            summary = metric.summary()
            lines.append(f"# TYPE {name} summary")
            for q, value in sorted(metric.quantiles(_QUANTILES).items()):
                label = escape_label_value(f"{q:g}")
                lines.append(
                    f'{name}{{quantile="{label}"}} {_fmt(value)}'
                )
            lines.append(f"{name}_sum {_fmt(summary['sum'])}")
            lines.append(f"{name}_count {_fmt(summary['count'])}")
            for bound in ("min", "max"):
                if summary[bound] is not None:
                    lines.append(f"# TYPE {name}_{bound} gauge")
                    lines.append(
                        f"{name}_{bound} {_fmt(summary[bound])}"
                    )
    return "\n".join(lines) + "\n"


def escape_help(text: str) -> str:
    """HELP-line escaping: backslash and newline (the text format does
    not escape quotes there)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


# ---------------------------------------------------------------------------
# health view
# ---------------------------------------------------------------------------


def health_view() -> dict:
    """The /healthz document: pipeline alive / degraded / broken, with
    the latched gauges and the stuck-window attribution when a bounded
    settle expired."""
    degraded = bool(_metrics.gauge("pipeline.degraded").value())
    broken_gauge = bool(_metrics.gauge("pipeline.broken").value())
    stuck = _flight.RECORDER.last_broken
    broken = broken_gauge or stuck is not None
    status = "broken" if broken else ("degraded" if degraded else "ok")
    return {
        "status": status,
        "pipeline_alive": not broken,
        "degraded": degraded,
        "degraded_flushes": _metrics.counter(
            "pipeline.degraded_flushes"
        ).value(),
        "fault_retries": _metrics.counter("pipeline.fault_retries").value(),
        "blocks_committed": _metrics.counter(
            "pipeline.blocks_committed"
        ).value(),
        "rollbacks": _metrics.counter("pipeline.rollbacks").value(),
        "stuck_window": stuck,
        "flight_records": len(_flight.RECORDER),
    }


# ---------------------------------------------------------------------------
# HTTP surface
# ---------------------------------------------------------------------------


class _Handler(BaseHTTPRequestHandler):
    server_version = "ect-introspect/1"
    protocol_version = "HTTP/1.1"
    # bounded keep-alive idle: HTTP/1.1 clients (requests.Session on the
    # Beacon-API data plane) hold persistent connections, parking a
    # non-daemon handler thread in a blocking read between requests —
    # without a socket timeout, stop()'s server_close join would wait on
    # the CLIENT's goodwill. One second bounds the join; an idle-expired
    # connection just reconnects on its next request.
    timeout = 1

    def log_message(self, fmt, *args):  # noqa: D102 — silence stderr
        pass

    # -- plumbing ------------------------------------------------------------
    def _send(self, status: int, content_type: str, body: bytes) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, doc, status: int = 200) -> None:
        body = json.dumps(doc, sort_keys=True, indent=1).encode("utf-8")
        self._send(status, "application/json; charset=utf-8", body)

    def _query(self) -> dict:
        return parse_qs(urlparse(self.path).query)

    def _param(self, params: dict, key: str, default=None):
        values = params.get(key)
        return values[0] if values else default

    def _try_apps(self, method: str, route: str, params: dict, body) -> bool:
        """Route into a mounted app when one claims the path; apps
        return (status, JSON document) and never raise. An app claims
        with ``prefix`` (one string) or ``prefixes`` (several); the
        LONGEST matching prefix across every mounted app wins, so the
        pool plane's ``/eth/v1/beacon/pool/...`` routes past the read
        plane's broader ``/eth/`` claim regardless of mount order.
        False → no app claimed the route."""
        best = None  # (prefix length, app)
        for app in getattr(self.server, "apps", ()):
            prefixes = getattr(app, "prefixes", None) or (app.prefix,)
            for prefix in prefixes:
                if route.startswith(prefix) and (
                    best is None or len(prefix) > best[0]
                ):
                    best = (len(prefix), app)
        if best is None:
            return False
        status, doc = best[1].handle(method, route, params, body)
        self._send_json(doc, status=status)
        return True

    # -- routes --------------------------------------------------------------
    def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        route = urlparse(self.path).path
        try:
            length = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(length) if length else b""
            try:
                body = json.loads(raw) if raw else None
            except ValueError:
                self._send_json(
                    {"code": 400, "message": "request body is not JSON"},
                    status=400,
                )
                return
            if not self._try_apps("POST", route, self._query(), body):
                self._send_json(
                    {"error": f"no route POST {route}"}, status=404
                )
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away mid-response

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        route = urlparse(self.path).path
        try:
            if route == "/metrics":
                self._send(
                    200,
                    "text/plain; version=0.0.4; charset=utf-8",
                    render_prometheus().encode("utf-8"),
                )
            elif route == "/healthz":
                view = health_view()
                self._send_json(
                    view, status=200 if view["pipeline_alive"] else 503
                )
            elif route == "/blocks":
                self._serve_blocks()
            elif route == "/device":
                params = self._query()
                try:
                    n = int(self._param(params, "n", "128"))
                except ValueError:
                    self._send_json({"error": "?n= must be an int"}, 400)
                    return
                self._send_json(_device.OBSERVATORY.snapshot(journal_n=n))
            elif route == "/memory":
                params = self._query()
                try:
                    n = int(self._param(params, "n", "12"))
                except ValueError:
                    self._send_json({"error": "?n= must be an int"}, 400)
                    return
                self._send_json(_memory.OBSERVATORY.snapshot(worst_n=n))
            elif route == "/trace":
                self._serve_trace()
            elif route == "/events":
                self._serve_events()
            elif route == "/":
                apps = getattr(self.server, "apps", ())
                self._send_json(
                    {
                        "service": "ethereum_consensus_tpu_torch introspection",
                        "endpoints": [
                            "/metrics",
                            "/healthz",
                            "/blocks",
                            "/events",
                            "/device",
                            "/memory",
                            "/trace",
                        ]
                        + [app.prefix + "..." for app in apps],
                        "apps": [type(app).__name__ for app in apps],
                    }
                )
            elif self._try_apps("GET", route, self._query(), None):
                pass
            else:
                self._send_json({"error": f"no route {route}"}, status=404)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away mid-response

    def _serve_blocks(self) -> None:
        params = self._query()
        recorder = _flight.RECORDER
        worst = self._param(params, "worst")
        outcome = self._param(params, "outcome")
        n = int(self._param(params, "n", "128"))
        try:
            if worst is not None:
                records = recorder.worst(n, field=worst)
            else:
                records = recorder.records()
                min_slot = self._param(params, "min_slot")
                max_slot = self._param(params, "max_slot")
                if min_slot is not None or max_slot is not None:
                    lo = int(min_slot) if min_slot is not None else 0
                    hi = (
                        int(max_slot)
                        if max_slot is not None
                        else (1 << 62)
                    )
                    records = [r for r in records if lo <= r.slot <= hi]
                if outcome is not None:
                    records = [
                        r
                        for r in records
                        if r.outcome == outcome or r.disposition == outcome
                    ]
                records = records[-n:]
        except ValueError as exc:
            self._send_json({"error": str(exc)}, status=400)
            return
        self._send_json(
            {
                "count": len(records),
                "recording": _flight.is_recording(),
                "capacity": recorder.capacity,
                "blocks": [r.to_dict() for r in records],
            }
        )

    def _serve_trace(self) -> None:
        """The causal-trace read side: bare → the slow-trace ring +
        recorder audit + per-histogram exemplar tables (the JSON home
        of exemplar evidence — /metrics stays strict text 0.0.4);
        ``?id=`` → one trace assembled across the three evidence planes
        (span tree, flight lineage, device events)."""
        params = self._query()
        recorder = _spans.RECORDER
        raw_id = self._param(params, "id")
        if raw_id is None:
            exemplars = {}
            for metric in _metrics.registered_metrics():
                if isinstance(metric, _metrics.Histogram):
                    table = metric.exemplars()
                    if table:
                        exemplars[metric.name] = table
            self._send_json(
                {
                    "recording": recorder.enabled,
                    "slow_traces": recorder.slow_traces(),
                    "audit": recorder.audit(),
                    "exemplars": exemplars,
                }
            )
            return
        try:
            trace_id = int(raw_id, 0)
        except ValueError:
            # the standard error envelope (code+message), as the data
            # plane's errors
            self._send_json(
                {"code": 400, "message": "?id= must be an int"}, 400
            )
            return
        tree = recorder.trace_tree(trace_id)
        if not tree["spans"]:
            self._send_json(
                {
                    "code": 404,
                    "message": f"no spans recorded for trace {trace_id}",
                    "trace_id": trace_id,
                },
                status=404,
            )
            return
        # flight lineage settled under this trace (admission→settle
        # outcome records), then the device span-plane evidence that
        # landed inside the trace's time window — routing decisions and
        # transfers share the span clock, so the join is a range scan.
        # Span t0_s values are recorder-relative, so absolute
        # perf_counter stamps rebase onto recorder.origin first; route
        # decisions are instants in the EVENTS ring, so both rings scan.
        tree["lineage"] = [
            r.to_dict() for r in _flight.RECORDER.by_trace(trace_id)
        ]
        origin = recorder.origin
        t_lo = tree["t0_s"]
        t_hi = t_lo + tree["duration_s"]
        device_events: list = []
        for rec in recorder.records():
            if not rec.name.startswith("device."):
                continue
            t0_s = rec.t0 - origin
            if t0_s < t_lo or t0_s > t_hi:
                continue
            device_events.append(
                {
                    "name": rec.name,
                    "t0_s": t0_s,
                    "duration_s": rec.duration_s,
                    "fields": rec.fields,
                }
            )
        for rec in recorder.event_records():
            if not rec.name.startswith("device."):
                continue
            t0_s = rec.ts - origin
            if t0_s < t_lo or t0_s > t_hi:
                continue
            device_events.append(
                {"name": rec.name, "t0_s": t0_s, "fields": rec.fields}
            )
        device_events.sort(key=lambda e: e["t0_s"])
        # bounded response, never a silent cap: the count survives
        tree["device_count"] = len(device_events)
        tree["device"] = device_events[:256]
        self._send_json(tree)

    def _serve_events(self) -> None:
        params = self._query()
        kinds_param = self._param(params, "kinds")
        kinds = (
            tuple(k.strip() for k in kinds_param.split(",") if k.strip())
            if kinds_param
            else _SSE_DEFAULT_KINDS
        )
        inbox: queue.Queue = queue.Queue(maxsize=1024)

        def push(kind, payload):
            if kind not in kinds:
                return
            try:
                inbox.put_nowait((kind, payload))
            except queue.Full:
                # a slow client drops events; it must never backpressure
                # the pipeline through the hook
                _metrics.counter("flight.sse_dropped_events").inc()

        _flight.HOOK.subscribe(push)
        try:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(b": ect introspection event stream\n\n")
            self.wfile.flush()
            keepalive_s = float(
                getattr(
                    self.server, "sse_keepalive_s", DEFAULT_SSE_KEEPALIVE_S
                )
            )
            import time as _time

            last_write = _time.monotonic()
            while not getattr(self.server, "stopping", False):
                try:
                    kind, payload = inbox.get(timeout=0.25)
                except queue.Empty:
                    # keepalive comment on the SSE interval (not every
                    # poll): an idle subscriber behind a proxy or LB
                    # keeps its stream alive, without the old
                    # 4-writes-per-second chatter; the 0.25 s poll still
                    # bounds stop() and dead-client discovery
                    now = _time.monotonic()
                    if now - last_write >= keepalive_s:
                        self.wfile.write(b": ping\n\n")
                        self.wfile.flush()
                        last_write = now
                    continue
                last_write = _time.monotonic()
                if isinstance(payload, _flight.BlockLineage):
                    payload = payload.to_dict()
                # default=repr: an exotic payload value (a state handle
                # would only appear here through a future event kind)
                # degrades to its repr instead of killing the stream
                data = json.dumps(payload, sort_keys=True, default=repr)
                self.wfile.write(
                    f"event: {kind}\ndata: {data}\n\n".encode("utf-8")
                )
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            _flight.HOOK.unsubscribe(push)


class IntrospectionServer:
    """Start/stoppable introspection endpoint over the process-wide
    telemetry state.

    Usage::

        server = IntrospectionServer(port=0).start()   # 0 = ephemeral
        ... replay ...
        server.stop()

    or as a context manager. ``start`` also begins a flight recording
    (``flight.start()``) unless told not to, so ``/blocks`` is live the
    moment the server is."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 sse_keepalive_s: float = DEFAULT_SSE_KEEPALIVE_S):
        self._lock = threading.Lock()
        self._host = host
        self._requested_port = port
        self._sse_keepalive_s = sse_keepalive_s
        self._httpd = None
        self._pool = None
        self._flight_started = False
        self._apps: tuple = ()

    def mount(self, app) -> "IntrospectionServer":
        """Mount a data-plane app (``.prefix`` + ``.handle(method, path,
        params, body) → (status, doc)``) — requests under the prefix
        route into it (the Beacon-API read plane, serving/handlers.py).
        Rebinds an immutable tuple, so handler threads iterate a
        consistent snapshot lock-free."""
        with self._lock:
            self._apps = self._apps + (app,)
            if self._httpd is not None:
                self._httpd.apps = self._apps
        return self

    # -- lifecycle -----------------------------------------------------------
    def start(self, start_flight: bool = True) -> "IntrospectionServer":
        with self._lock:
            if self._httpd is not None:
                return self
            httpd = ThreadingHTTPServer(
                (self._host, self._requested_port), _Handler
            )
            # non-daemon handler threads + block_on_close: server_close()
            # JOINS every in-flight handler, so stop() returns only after
            # SSE subscribers have detached from the commit hook (their
            # loops exit within one `stopping` poll, so the join is
            # bounded at ~0.25s)
            httpd.daemon_threads = False
            httpd.stopping = False
            httpd.apps = self._apps
            httpd.sse_keepalive_s = self._sse_keepalive_s
            pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="introspection-accept"
            )
            pool.submit(httpd.serve_forever, 0.1)
            self._httpd = httpd
            self._pool = pool
            self._flight_started = bool(
                start_flight and not _flight.is_recording()
            )
        if self._flight_started:
            _flight.start()
        return self

    def stop(self) -> None:
        with self._lock:
            httpd, pool = self._httpd, self._pool
            flight_started = self._flight_started
            self._httpd = None
            self._pool = None
            self._flight_started = False
        if httpd is None:
            return
        httpd.stopping = True  # SSE loops exit at their next poll
        httpd.shutdown()
        httpd.server_close()
        pool.shutdown(wait=False)
        if flight_started:
            _flight.stop()

    def __enter__(self) -> "IntrospectionServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()

    # -- addressing ----------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._httpd is not None

    @property
    def port(self) -> int:
        httpd = self._httpd
        if httpd is None:
            raise RuntimeError("server is not running")
        return httpd.server_address[1]

    def url(self, path: str = "/") -> str:
        return f"http://{self._host}:{self.port}{path}"

    def __repr__(self) -> str:
        if self.running:
            return f"IntrospectionServer(on {self.url()})"
        return "IntrospectionServer(stopped)"
