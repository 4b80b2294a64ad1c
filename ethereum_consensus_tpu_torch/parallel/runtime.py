"""Mesh runtime: one process-wide provisioned mesh behind ``ECT_MESH``.

The production switch that routes four hot paths through the mesh
(``mesh.py``):

* the altair epoch sweeps (models/epoch_vector.py → ``epoch.py``
  ``MeshEpochSweeps``: row-sharded kernels and psum reductions),
* the RLC batch of a window (crypto/bls.py → ``pairing.py``
  ``batch_verify_sharded``),
* large flat ``hash_tree_root`` rebuilds (ssz/merkle.py's mesh hook →
  ``merkle.py`` ``sharded_merkleize_chunks``),
* a multiproof's columnar group rebuild (proofs/multiproof.py behind the
  ``proof_gather`` gate: its ``hash_level`` passes ride the installed
  device hasher).

``ECT_MESH=N`` provisions a mesh over the first N devices of the routed
type (``ops.install(device=...)``, "cuda" by default; N=1 is legal — it
exercises the sharded code paths on one device), ``ECT_MESH=auto`` takes
every device when there are at least two, and unset/``off`` disables the
runtime — the host layers then never import this package.

Every engage bumps ``mesh.engage`` and ``mesh.engage.{kind}``; every
decline bumps ``mesh.decline.{reason}``. While the device observatory is
on, both journal a ``mesh.{kind}`` routing entry with their inputs, as the
reference's do. The declines are routing decisions
of the configuration, as the reference's: ``below_threshold``,
``phase0_family``, ``mesh_shape`` (a mesh the merkle tree cannot split
into aligned subtrees), ``single_device`` (``auto`` on one device), and the
epoch engine's spec-preserving ``u64_product`` and ``wrap_guard``. Device
trouble is not a decline here: where the reference returns the work to the
host (``device_unusable``, its fault hook's recovery), the port raises — a
mesh that cannot be built (a bad value, more devices than there are), a
failing shard kernel, and an injected fault.

Provisioning happens once per process, at the first consult (not at
import): the merkle hook is installed then, so the state roots before the
first mesh consult do not take it. The reference's one-shot trace event a
decline and its journal entry for the provisioning itself are left out.

Reference parity: ethereum_consensus_tpu/parallel/runtime.py (``requested``
:107, ``_provision`` :142, ``epoch_sweeps`` :283, ``pairing_mesh`` :324,
``proof_gather`` :346, ``_install_merkle_hook`` :375,
``install_fault_hook``/``fault_point`` :250/:262, ``reset`` :413).
"""

from __future__ import annotations

import threading

from .. import _env
from ..telemetry import device as _device_obs
from ..telemetry import metrics as _metrics

__all__ = [
    "MESH_ENV",
    "EPOCH_MIN_ENV",
    "MERKLE_MIN_ENV",
    "PROOF_MIN_ENV",
    "DEFAULT_EPOCH_MIN_N",
    "DEFAULT_MERKLE_MIN_CHUNKS",
    "DEFAULT_PROOF_MIN_CHUNKS",
    "MeshFaultInjected",
    "decline",
    "device_count",
    "epoch_sweeps",
    "fault_point",
    "install_fault_hook",
    "mesh",
    "pairing_mesh",
    "proof_gather",
    "requested",
    "reset",
    "status",
]

MESH_ENV = "ECT_MESH"
EPOCH_MIN_ENV = "ECT_MESH_EPOCH_MIN_N"
MERKLE_MIN_ENV = "ECT_MESH_MERKLE_MIN_CHUNKS"
PROOF_MIN_ENV = "ECT_MESH_PROOF_MIN_CHUNKS"

# the reference's crossover defaults (measured on a TPU; the crossover on
# this card has not been measured)
DEFAULT_EPOCH_MIN_N = 1 << 17
DEFAULT_MERKLE_MIN_CHUNKS = 1 << 15
# a multiproof's columnar group rebuild: the total chunks across the groups
# it plans; below this the per-group lazy Trees on the host
DEFAULT_PROOF_MIN_CHUNKS = 1 << 14

_LOCK = threading.Lock()
# provisioning outcome, written once under _LOCK then read lock-free:
# None = not yet provisioned; (mesh_or_None, reason) afterwards
_PROVISIONED: "tuple | None" = None


class MeshFaultInjected(RuntimeError):
    """An injected mesh-route fault, raised from inside a sharded path
    (``fault_point``). The reference recovers it on the host; the port
    raises it to the caller."""


def requested() -> bool:
    """Is the mesh runtime switched on at all? A plain env read."""
    return _env.mesh_requested(MESH_ENV)


def decline(kind: str, reason: str, **inputs) -> None:
    """Count one declined mesh route (``mesh.decline.{reason}``): a routing
    decision, so none is silent. ``kind`` names the route (epoch, pairing,
    merkle, proofs, runtime); while the device observatory is on, the
    decline journals a ``mesh.{kind}`` entry on the host with ``inputs``."""
    _metrics.counter(f"mesh.decline.{reason}").inc()
    if _device_obs.OBSERVATORY.active:
        _device_obs.route(f"mesh.{kind}", "host", reason, **inputs)


def _engage(kind: str, **inputs) -> None:
    """Count one engaged mesh route (``mesh.engage``, and
    ``mesh.engage.{kind}``) and journal it as ``decline`` does."""
    _metrics.counter("mesh.engage").inc()
    _metrics.counter(f"mesh.engage.{kind}").inc()
    if _device_obs.OBSERVATORY.active:
        _device_obs.route(f"mesh.{kind}", "device", "engaged", **inputs)


def _provision() -> tuple:
    """Resolve ECT_MESH into a provisioned Mesh (or a decline reason). Runs
    once per process; a value that cannot be met raises, every time it is
    consulted."""
    global _PROVISIONED
    if _PROVISIONED is not None:
        return _PROVISIONED
    with _LOCK:
        if _PROVISIONED is not None:
            return _PROVISIONED
        outcome = _provision_locked(_env.mode(MESH_ENV))
        if outcome[0] is not None:
            # the merkle hook rides provisioning: one install at the first
            # consult, as the reference's
            _install_merkle_hook(outcome[0])
        _PROVISIONED = outcome
    return _PROVISIONED


def _provision_locked(value: str) -> tuple:
    from .mesh import chip_mesh, device_count as _available

    available = _available()
    if value == "auto":
        if available < 2:
            decline("runtime", "single_device", devices=available)
            return None, "single_device"
        n = available
    else:
        try:
            n = int(value)
        except ValueError:
            raise ValueError(f"{MESH_ENV}={value!r}: expected a device count, auto or off") \
                from None
        if n < 1:
            raise ValueError(f"{MESH_ENV}={value!r}: expected a device count, auto or off")
        if n > available:
            raise RuntimeError(
                f"{MESH_ENV}={n}: the mesh needs {n} devices, {available} available")
    built = chip_mesh(n)
    _metrics.gauge("mesh.devices").set(n)
    return built, "engaged"


def mesh():
    """The provisioned mesh, or None (not requested, or ``auto`` on one
    device)."""
    if not requested():
        return None
    return _provision()[0]


def device_count() -> int:
    m = mesh()
    return m.n_dev if m is not None else 0


def status() -> dict:
    """Runtime state: whether the mesh was requested, the env value, the
    devices, and the provisioning outcome."""
    value = _env.mode(MESH_ENV) or "off"
    if not requested():
        return {"requested": False, "env": value, "devices": 0}
    m, reason = _provision()
    return {"requested": True, "env": value, "devices": m.n_dev if m is not None else 0,
            "reason": reason}


# -- fault injection under the mesh route ------------------------------------

# one process-wide hook, written under _FAULT_LOCK and read lock-free on the
# routed paths; a callable (kind: str) -> bool, True consuming one planned
# fault for that route kind
_FAULT_HOOK = None
_FAULT_LOCK = threading.Lock()


def install_fault_hook(hook) -> None:
    """Arm (or with ``None`` disarm) the mesh fault-injection seam. The
    sharded paths (``pairing.py``, ``epoch.py``) call ``fault_point`` on
    entry."""
    global _FAULT_HOOK
    with _FAULT_LOCK:
        _FAULT_HOOK = hook


def fault_point(kind: str, **inputs) -> None:
    """The injection seam the sharded paths run on entry: when the
    installed hook consumes a planned fault for ``kind``, count the decline
    (``mesh.decline.injected_fault``) and raise ``MeshFaultInjected``. The
    reference's host fallback recovers it; the port's caller sees it."""
    hook = _FAULT_HOOK
    if hook is None or not hook(kind):
        return
    decline(kind, "injected_fault", **inputs)
    raise MeshFaultInjected(f"injected mesh fault on the {kind} route: {inputs}")


# -- the routed hot paths ---------------------------------------------------


def epoch_sweeps(n_validators: int, family: str = "altair"):
    """A ``MeshEpochSweeps`` runner for an ``n_validators`` registry, or
    None with the decline counted (the caller runs its unsharded kernels).
    Only the altair-family sweeps (inactivity and flag rewards) have sharded
    twins; phase0's pending-attestation rewards decline explicitly."""
    if not requested():
        return None
    if family != "altair":
        decline("epoch", f"{family}_family", validators=n_validators)
        return None
    m, reason = _provision()
    if m is None:
        decline("epoch", reason, validators=n_validators)
        return None
    threshold = _env.threshold(EPOCH_MIN_ENV, DEFAULT_EPOCH_MIN_N)
    if n_validators < threshold:
        decline("epoch", "below_threshold", validators=n_validators, threshold=threshold,
                devices=m.n_dev)
        return None
    from .epoch import MeshEpochSweeps

    runner = MeshEpochSweeps(m)
    _engage("epoch", validators=n_validators, devices=m.n_dev,
            rows_per_device=-(-n_validators // m.n_dev))
    return runner


def pairing_mesh(n_sets: int):
    """The mesh for one RLC batch's sharded pairing, or None (the caller
    keeps the unsharded route). The pairing-size threshold itself lives in
    ``_device_flags.pairing_enabled``: by the time crypto/bls.py consults
    this, the batch is already routed to the device."""
    if not requested():
        return None
    m, reason = _provision()
    if m is None:
        decline("pairing", reason, sets=n_sets)
        return None
    _engage("pairing", sets=n_sets, devices=m.n_dev, sets_per_device=-(-n_sets // m.n_dev))
    return m


def proof_gather(n_chunks: int):
    """The mesh for one multiproof's columnar group rebuild, or None (the
    caller builds lazy per-group Trees on the host). ``n_chunks`` is the
    total chunk count across the planned groups: the columnar build joins
    them into one buffer whose ``hash_level`` passes ride the installed
    device hasher, so the threshold gates on the whole batch."""
    if not requested():
        return None
    m, reason = _provision()
    if m is None:
        decline("proofs", reason, chunks=n_chunks)
        return None
    threshold = _env.threshold(PROOF_MIN_ENV, DEFAULT_PROOF_MIN_CHUNKS)
    if n_chunks < threshold:
        decline("proofs", "below_threshold", chunks=n_chunks, threshold=threshold,
                devices=m.n_dev)
        return None
    _engage("proofs", chunks=n_chunks, devices=m.n_dev)
    return m


def _install_merkle_hook(m) -> None:
    """Point ssz/merkle.py's mesh seam at the sharded merkleizer: large flat
    rebuilds (cold column materializations, whole-list roots) divide their
    leaf ranges over the mesh. A mesh the tree cannot split returns None
    (``mesh_shape``), and the host merkleizer runs; a failing kernel
    raises."""
    from ..ssz import merkle as ssz_merkle

    min_chunks = _env.threshold(MERKLE_MIN_ENV, DEFAULT_MERKLE_MIN_CHUNKS)
    n_dev = m.n_dev

    def mesh_merkleize(chunks: bytes, limit: "int | None") -> "bytes | None":
        # the shape check before dispatch: sharded_merkleize_chunks hands
        # such meshes to the host merkleizer, which would re-enter this hook
        count = len(chunks) // 32
        width = ssz_merkle.next_pow_of_two(count if limit is None else limit)
        if n_dev & (n_dev - 1) or n_dev > width:
            decline("merkle", "mesh_shape", chunks=count, devices=n_dev, width=width)
            return None
        from .merkle import sharded_merkleize_chunks

        root = sharded_merkleize_chunks(chunks, m, limit=limit)
        _engage("merkle", chunks=count, devices=n_dev)
        return root

    ssz_merkle.register_mesh_merkleizer(mesh_merkleize, min_chunks)


def reset() -> None:
    """Drop the provisioned mesh and the hooks (tests: lets one process
    exercise several ECT_MESH configurations)."""
    global _PROVISIONED
    with _LOCK:
        _PROVISIONED = None
        install_fault_hook(None)
        from ..ssz import merkle as ssz_merkle

        ssz_merkle.register_mesh_merkleizer(None, None)
