"""The window of tests/test_torch_window.py on the port's "mxu" multiplier.

With ``fq8.set_multiplier("mxu")`` every product of the B6 and B7 plain
versions on the device route (``ops.install(device="cpu",
pairing_min_sets=2)``) is ``fq8.mont7r``'s: the ten sets' verdicts and the
blame of the copy with one aggregate's signature replaced by its
neighbour's must be the host route's, and a failing mxu product raises out
of ``verify_signature_sets`` with no host route or u64 product answering
for it. A file of its own, so that the suite's workers take it beside the
u64 window.
"""

import pytest

from ethereum_consensus_tpu_torch import ops
from ethereum_consensus_tpu_torch.crypto import bls as port_bls
from ethereum_consensus_tpu_torch.native import bls as port_native
from ethereum_consensus_tpu_torch.ops import fq8
from test_torch_window import TAMPERED, _tampered, chain, port_device_route, port_sets  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture
def mxu_device_route(port_device_route):
    fq8.set_multiplier("mxu")
    yield
    fq8.set_multiplier("u64")


def test_window_verdicts_and_blame_on_the_mxu_multiplier(port_sets, mxu_device_route):
    tampered = _tampered(port_bls, port_sets)
    assert port_bls.verify_signature_sets(port_sets) == [True] * len(port_sets)
    assert port_bls.last_batch_route() == "device"
    mxu_blame = port_bls.verify_signature_sets(tampered)
    assert port_bls.last_batch_route() == "device"
    ops.uninstall()  # the host route, with the switch still on mxu
    assert port_bls.verify_signature_sets(tampered) == mxu_blame
    assert port_bls.last_batch_route() == "host"
    assert [i for i, ok in enumerate(mxu_blame) if not ok] == [TAMPERED]


def test_a_failing_mxu_product_raises(port_sets, mxu_device_route, monkeypatch):
    """The mxu product fails in the set sums, the first work of the route:
    the failure propagates, nothing takes the u64 product instead, and the
    host multi-pairing is never asked."""
    def failed(*args):
        raise RuntimeError("mont_mxu kernel launch failed: CUDA error 719")

    def host_route(*args):
        raise AssertionError("the host multi-pairing answered for the device")

    monkeypatch.setattr(fq8, "mont7r_plain", failed)
    monkeypatch.setattr(port_native, "batch_verify_raw", host_route)
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        port_bls.verify_signature_sets(port_sets)
