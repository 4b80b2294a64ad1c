"""The port's introspection server (telemetry/server.py) and the selfcheck's
``--serve`` flags.

The Prometheus rendering and the name and label escaping against the
reference's on the same metric objects; the server's routes over HTTP on
localhost (``/metrics``, ``/healthz``, ``/blocks``, ``/events``, ``/device``,
``/memory``, ``/trace``) during a pipelined replay of the port; ``mount``
with the longest prefix winning; and ``python -m
ethereum_consensus_tpu_torch.pipeline --selfcheck --serve 0 --serve-data
--hold SECONDS`` in a subprocess, read over HTTP while it holds.
"""

import json
import subprocess
import sys
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

import chain_utils
import torch_genesis
from ethereum_consensus_tpu.telemetry import metrics as ref_metrics
from ethereum_consensus_tpu.telemetry import server as ref_server
from ethereum_consensus_tpu_torch.config import Context
from ethereum_consensus_tpu_torch.executor import Executor
from ethereum_consensus_tpu_torch.models.phase0 import containers
from ethereum_consensus_tpu_torch.pipeline import FlushPolicy
from ethereum_consensus_tpu_torch.telemetry import flight, metrics
from ethereum_consensus_tpu_torch.telemetry import server as tel_server
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
N_BLOCKS = 16


def _get(url: str) -> bytes:
    return urllib.request.urlopen(url, timeout=30).read()


def _get_json(url: str):
    return json.loads(_get(url))


@pytest.fixture(scope="module")
def chain16():
    ref_state, ref_ctx = torch_genesis.fresh_genesis(64, "minimal")
    blocks = chain_utils.produce_chain(ref_state, ref_ctx, N_BLOCKS)
    ctx = Context.for_minimal()
    ns = containers.build(ctx.preset)
    return (ns.BeaconState.deserialize(type(ref_state).serialize(ref_state)), ctx,
            [ns.SignedBeaconBlock.deserialize(type(b).serialize(b)) for b in blocks])


@pytest.fixture
def live_server():
    metrics.gauge("pipeline.degraded").set(0)
    metrics.gauge("pipeline.broken").set(0)
    rec = flight.start()
    srv = tel_server.IntrospectionServer(port=0).start(start_flight=False)
    try:
        yield srv
    finally:
        srv.stop()
        flight.stop()
        rec.clear()


def _golden(module):
    c = module.Counter("golden.requests")
    c.inc(3)
    g = module.Gauge("golden.queue-depth")
    g.set(2)
    h = module.Histogram("golden.latency_s", sample_limit=64)
    for v in (1, 2, 3, 4, 2.5):
        h.observe(v)
    return [c, g, h]


def test_prometheus_rendering_equals_reference():
    text = tel_server.render_prometheus(_golden(metrics))
    assert text == ref_server.render_prometheus(_golden(ref_metrics))
    assert text.splitlines()[:3] == ["# HELP golden_requests golden.requests",
                                     "# TYPE golden_requests counter", "golden_requests 3"]
    for name in ("a.b.c_s", "3startswithdigit", "weird séance", ""):
        assert tel_server.prometheus_name(name) == ref_server.prometheus_name(name)
    value = 'say "hi"\nback\\slash'
    assert tel_server.escape_label_value(value) == ref_server.escape_label_value(value)
    assert tel_server.escape_help("line\nbreak\\x") == ref_server.escape_help("line\nbreak\\x")


def test_health_view_keys_equal_reference(live_server):
    view = _get_json(live_server.url("/healthz"))
    assert set(view) == set(ref_server.health_view())
    assert view["status"] == "ok" and view["pipeline_alive"]
    body = _get(live_server.url("/metrics")).decode()
    info = [line for line in body.splitlines() if line.startswith("build_info{")]
    assert len(info) == 1 and 'torch="' in info[0] and info[0].endswith(" 1")
    assert set(tel_server.build_info_labels()) == {"git_sha", "torch", "numpy", "cuda", "backend"}


def test_routes_during_a_pipelined_replay(chain16, live_server):
    """/events sees every commit in chain order, /metrics scrapes while the
    pipeline runs, /blocks holds one lineage record a block, and /device,
    /memory and /trace answer JSON."""
    state, ctx, blocks = chain16
    events: list = []
    scrapes: list = []
    metrics.counter("pipeline.blocks_committed")
    expected_commits = N_BLOCKS // 8

    def read_events(url):
        payload = None
        for raw in urllib.request.urlopen(url, timeout=60):
            line = raw.decode().strip()
            if line.startswith("event: "):
                payload = line.split(": ", 1)[1]
            elif line.startswith("data: ") and payload is not None:
                events.append((payload, json.loads(line[len("data: "):])))
                payload = None
                if sum(1 for k, _ in events if k == "commit") >= expected_commits:
                    return

    def scrape(url):
        for _ in range(10):
            scrapes.append(_get(url).decode())
            time.sleep(0.01)

    with ThreadPoolExecutor(max_workers=2) as pool:
        sse = pool.submit(read_events, live_server.url("/events"))
        scraper = pool.submit(scrape, live_server.url("/metrics"))
        time.sleep(0.2)
        stats = Executor(state.copy(), ctx).stream(
            blocks, policy=FlushPolicy(window_size=8, max_in_flight=2))
        sse.result(timeout=60)
        scraper.result(timeout=60)
    assert stats.blocks_committed == N_BLOCKS
    commits = [s for kind, data in events if kind == "commit" for s in data["slots"]]
    assert commits == [int(b.message.slot) for b in blocks]
    assert scrapes and all("# TYPE pipeline_blocks_committed counter" in s for s in scrapes)
    doc = _get_json(live_server.url("/blocks?n=64"))
    assert doc["count"] == N_BLOCKS
    assert [b["slot"] for b in doc["blocks"]] == [int(b.message.slot) for b in blocks]
    worst = [b["total_s"] for b in _get_json(live_server.url("/blocks?worst=total_s&n=3"))["blocks"]]
    assert worst == sorted(worst, reverse=True)
    assert _get_json(live_server.url("/blocks?min_slot=3&max_slot=5"))["count"] == 3
    assert {"routing_journal", "launch_ledger"} <= set(_get_json(live_server.url("/device?n=4")))
    assert "census" in _get_json(live_server.url("/memory?n=3"))
    assert set(_get_json(live_server.url("/trace"))) >= {"recording", "slow_traces", "audit"}
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(live_server.url("/trace?id=zz"))
    assert err.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(live_server.url("/nope"))
    assert err.value.code == 404


class _App:
    def __init__(self, prefix: str, name: str):
        self.prefix = prefix
        self.name = name
        self.seen: list = []

    def handle(self, method, path, params, body):
        self.seen.append((method, path, params, body))
        return 200, {"app": self.name, "path": path}


def test_mount_routes_the_longest_prefix(live_server):
    broad, narrow = _App("/eth/", "broad"), _App("/eth/v1/beacon/pool/", "narrow")
    live_server.mount(narrow).mount(broad)
    assert _get_json(live_server.url("/eth/v1/beacon/pool/x?y=1"))["app"] == "narrow"
    assert _get_json(live_server.url("/eth/v1/beacon/states/head/root"))["app"] == "broad"
    assert narrow.seen == [("GET", "/eth/v1/beacon/pool/x", {"y": ["1"]}, None)]
    request = urllib.request.Request(live_server.url("/eth/v1/validator/duties/attester/1"),
                                     data=b"[1, 2]", method="POST")
    assert json.loads(urllib.request.urlopen(request, timeout=30).read())["app"] == "broad"
    assert broad.seen[-1][3] == [1, 2]
    request = urllib.request.Request(live_server.url("/eth/x"), data=b"{not json", method="POST")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(request, timeout=30)
    assert err.value.code == 400
    root = _get_json(live_server.url("/"))
    assert root["apps"] == ["_App", "_App"] and "/metrics" in root["endpoints"]


def test_start_stop_idempotent_and_flight_lifecycle():
    srv = tel_server.IntrospectionServer(port=0)
    assert not srv.running
    srv.start()
    try:
        assert srv.running and flight.is_recording()
        srv.start()
        assert _get_json(f"http://127.0.0.1:{srv.port}/")["endpoints"]
    finally:
        srv.stop()
    assert not srv.running and not flight.is_recording()
    srv.stop()


def test_selfcheck_serves_the_data_plane_while_it_holds():
    """``--selfcheck --serve 0 --serve-data --hold 8`` on the CPU: the
    chain tier's commits feed the data plane, which answers over HTTP while
    the server holds; the process exits 0 after the hold."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "ethereum_consensus_tpu_torch.pipeline", "--selfcheck",
         "--device", "cpu", "--serve", "0", "--serve-data", "--hold", "8"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: list = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("data plane head:"):
                break
        assert lines and lines[-1].startswith("data plane head:"), "".join(lines)
        url = lines[-1].rsplit(" ", 1)[1].strip()
        rows = _get_json(url)["data"]
        assert [r["index"] for r in rows] == ["0", "1", "2"]
        base = url.split("/eth/")[0]
        assert _get_json(base + "/healthz")["blocks_committed"] >= 3
        head = _get_json(base + "/eth/v1/beacon/states/head/root")["data"]["root"]
        assert head.startswith("0x") and len(head) == 66
    finally:
        out, _ = proc.communicate(timeout=120)
    lines.append(out)
    assert proc.returncode == 0, "".join(lines)
    assert "selfcheck OK" in "".join(lines)


def test_serve_data_without_serve_is_refused():
    done = subprocess.run(
        [sys.executable, "-m", "ethereum_consensus_tpu_torch.pipeline", "--selfcheck",
         "--device", "cpu", "--serve-data"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert done.returncode != 0
    assert "--serve-data requires --serve PORT" in done.stderr
