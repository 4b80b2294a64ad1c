"""The port's four epoch routes, for the altair-family parity tests.

* ``columnar`` — the columnar engine forced on at toy sizes, staged host
  kernels;
* ``literal`` — the literal stage list (``ECT_EPOCH_VECTOR=off``);
* ``device_fused`` — ``ops.install(device="cpu", ...)`` with the sweeps,
  shuffle and hasher thresholds lowered (the G1 aggregation keeps its host
  threshold: its plain version costs about a second a block): the engine
  stays columnar and runs inactivity and rewards through the fused epoch
  kernel's plain version;
* ``device_literal`` — the same install with the engine off: the literal
  stages reach the plain versions of the altair-family sweep kernels.

Parametrize the ``route`` fixture indirectly with ``ROUTES``. It yields a
``Route``: the counter that advances once per boundary on the route, the
calls of the kernels' plain versions seen on it, and the inactivity-penalty
denominator each of those took (which fork's quotient reached the kernel).
"""

import inspect

import pytest

from ethereum_consensus_tpu_torch import ops
from ethereum_consensus_tpu_torch.models import epoch_vector, ops_vector
from ethereum_consensus_tpu_torch.ops import epoch as port_epoch
from ethereum_consensus_tpu_torch.ops import sweeps
from ethereum_consensus_tpu_torch.ssz import hash as port_hash
from ethereum_consensus_tpu_torch.telemetry import metrics

ROUTES = ["columnar", "literal", "device_fused", "device_literal"]
SWEEP_PLAINS = ("flag_deltas_plain", "inactivity_updates_plain", "inactivity_penalties_plain")
_COUNTERS = {
    "columnar": "epoch_vector.epochs",
    "literal": "epoch_vector.fallback.disabled",
    "device_fused": "epoch_vector.fused.device",
    "device_literal": "epoch_vector.fallback.disabled",
}


class Route:
    def __init__(self, name: str):
        self.name = name
        self.counter = metrics.counter(_COUNTERS[name])
        self.plain_calls: dict = {}
        self.denominators: list = []

    def fused_fallbacks(self) -> int:
        return sum(metrics.counter(n).value() for n in metrics.registered()
                   if n.startswith("epoch_vector.fused_fallback."))


@pytest.fixture
def route(request, monkeypatch):
    """Put the port on one route."""
    ops.uninstall()
    monkeypatch.setattr(epoch_vector, "EPOCH_VECTOR_MIN_VALIDATORS", 0)
    monkeypatch.setattr(ops_vector, "BATCH_MIN_VALIDATORS", 0)
    r = Route(request.param)
    if r.name in ("literal", "device_literal"):
        monkeypatch.setenv("ECT_EPOCH_VECTOR", "off")
    if r.name.startswith("device"):
        monkeypatch.setattr(port_hash, "DEVICE_MIN_NODES", 256)
        monkeypatch.setattr(port_hash, "_device_hasher", None)
        ops.install(device="cpu", sweeps_min_n=1, shuffle_min_n=1)
    for fn_name in SWEEP_PLAINS + ("fused_epoch_plain",):
        module = port_epoch if fn_name == "fused_epoch_plain" else sweeps
        plain = getattr(module, fn_name)
        signature = inspect.signature(plain)

        def counting(*args, _plain=plain, _name=fn_name, _signature=signature, **kwargs):
            r.plain_calls[_name] = r.plain_calls.get(_name, 0) + 1
            bound = _signature.bind(*args, **kwargs).arguments
            if "denominator" in bound:
                r.denominators.append(bound["denominator"])
            return _plain(*args, **kwargs)

        monkeypatch.setattr(module, fn_name, counting)
    yield r
    ops.uninstall()


def check_kernels(route: Route, boundaries: int) -> None:
    """Each route reached the plain versions it should, and only those:
    ``boundaries`` is how far the route's counter advanced."""
    calls = route.plain_calls
    if route.name == "device_fused":
        assert calls == {"fused_epoch_plain": boundaries}
    elif route.name == "device_literal":
        # the boundary into epoch 1 of a genesis state skips inactivity
        # and rewards (current epoch == GENESIS_EPOCH)
        assert calls.get("flag_deltas_plain", 0) == 3 * calls.get("inactivity_updates_plain", 0)
        assert calls.get("inactivity_penalties_plain", 0) == calls.get("inactivity_updates_plain", 0)
        assert calls.get("inactivity_updates_plain", 0) >= 1
    else:
        assert calls == {}


def identity(state, ref_bytes: bytes, ref_root: bytes) -> bool:
    """The port's state serializes and roots as the reference's did."""
    typ = type(state)
    return typ.serialize(state) == ref_bytes and typ.hash_tree_root(state) == ref_root
