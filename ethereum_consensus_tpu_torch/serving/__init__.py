"""serving — the hot-state Beacon-API read data plane.

Beacon-API READ endpoints served straight from columnar snapshots of
pipeline-committed states, mounted on the introspection server
(``telemetry/server.py``).

* ``headstore``  — ``HeadStore``/``Snapshot``: bounded history of
  immutable per-commit state snapshots off the pipeline commit hook's
  state channel, with ``state_id`` (head/slot/root/finalized/justified)
  resolution and copy-on-write isolation from the live pipeline.
* ``views``      — columnar resolution: status codes, batch gathers,
  status-filter masks, the vectorized rewards summary. One columnar
  gather per request batch.
* ``oracle``     — the scalar per-validator twin of every document:
  fallback path AND differential oracle (tests/test_serving.py).
* ``handlers``   — ``BeaconDataPlane``: the mountable route table
  (validators, balances, committees, sync committees, duties, rewards,
  root/fork/finality/randao/genesis) in standard Beacon-API wire
  format.

Quickstart::

    store = HeadStore().attach()            # feed from pipeline commits
    server = IntrospectionServer(port=8799).start()
    server.mount(BeaconDataPlane(store))
    ... pipeline replay ...                 # every commit publishes
    GET server.url("/eth/v1/beacon/states/head/validators?id=1,2,3")

or ``python -m ethereum_consensus_tpu_torch.pipeline --selfcheck --serve 0
--serve-data --hold SECONDS``.

Reference parity: ethereum_consensus_tpu/serving/__init__.py.
"""

from .handlers import BeaconDataPlane
from .headstore import HeadStore, Snapshot

__all__ = ["BeaconDataPlane", "HeadStore", "Snapshot"]
