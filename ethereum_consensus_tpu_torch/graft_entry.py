"""Entry points: the twin of the reference's ``__graft_entry__.py``.

``entry(device)``            — the single-device merkle forward step: the SSZ
                               hash_tree_root reduction (B2) over 2048 leaves.
``dryrun_multichip(n, ...)`` — the full distributed chain step (sharded
                               validator sweep, its total, the cross-shard
                               merkleization), the sharded epoch sweep step,
                               the mesh-sharded set aggregation and RLC batch,
                               and one signed altair block applied with
                               device routing on, each checked against the
                               host.

The reference runs its dryrun in a subprocess on a virtual n-device JAX CPU
platform, because touching a broken TPU backend could hang the caller. The
port's mesh is a tuple of torch devices in this process, so the dryrun runs
here on ``virtual_mesh(n, device)``: n shards of the one card, or of the host
when the caller asks for "cpu".

The block stage needs an altair state whose keys are real, and the port has
no genesis module yet: the caller hands over the pre-state, the signed block
and the context (``block=(state, signed_block, context)``); without them the
dryrun raises.

Reference parity: __graft_entry__.py (``entry`` :35, ``dryrun_multichip``
:59, ``_stage`` :92, ``_dryrun_body`` :114).
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

__all__ = ["dryrun_multichip", "entry"]

ENTRY_LEAVES = 2048
DRYRUN_VALIDATORS = (1 << 13) + 5


def entry(device="cuda"):
    """Return ``(fn, example_args)``: ``fn`` maps ((8, N) int32 leaf words,
    the (64, 8) zero-subtree table) to the (8,) int32 root words of a
    depth-log2(N) tree, through B2 on ``device``."""
    from .ops.merkle import reduce_levels, zero_hash_words

    depth = (ENTRY_LEAVES - 1).bit_length()

    def merkle_forward(nodes, zero_words):
        return reduce_levels(nodes, zero_words, depth)

    rng = np.random.default_rng(1234)
    leaves = rng.integers(0, 2**32, size=(8, ENTRY_LEAVES), dtype=np.uint64).astype(np.uint32)
    nodes = torch.from_numpy(leaves.view(np.int32)).to(device)
    return merkle_forward, (nodes, zero_hash_words(torch.device(device)))


class _stage:
    """Context manager printing a stage's wall clock (flushed at once, so
    a killed run still shows the stages that completed) and keeping it in
    ``walls``."""

    def __init__(self, name: str, walls: dict):
        self.name = name
        self.walls = walls

    def __enter__(self):
        self.t0 = time.monotonic()
        print(f"[dryrun] {self.name} ...", flush=True)
        return self

    def __exit__(self, exc_type, exc, tb):
        seconds = time.monotonic() - self.t0
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__})"
        print(f"[dryrun] {self.name}: {status} in {seconds:.1f}s", flush=True)
        self.walls[self.name] = seconds
        return False


@contextlib.contextmanager
def _mesh_switch(value: str):
    """``ECT_MESH=value`` around a fresh mesh runtime; the caller's value
    and runtime state come back after."""
    from .parallel import runtime

    saved = os.environ.get(runtime.MESH_ENV)
    runtime.reset()
    os.environ[runtime.MESH_ENV] = value
    try:
        yield runtime
    finally:
        if saved is None:
            os.environ.pop(runtime.MESH_ENV, None)
        else:
            os.environ[runtime.MESH_ENV] = saved
        runtime.reset()


def _check(ok: bool, message: str) -> None:
    if not ok:
        raise AssertionError(message)


def dryrun_multichip(n_devices: int, device="cuda", *, block=None,
                     validators: int = DRYRUN_VALIDATORS) -> dict:
    """Run the five stages of the reference's dryrun on
    ``virtual_mesh(n_devices, device)``, each checked against the host, and
    return each stage's wall seconds with the summary's values.

    ``block`` is ``(pre_state, signed_block, context)`` of the block stage:
    an altair state whose validators hold real keys and a signed block for
    it. ``validators`` sizes the chain step and the epoch step (the
    reference's 2^13 + 5, an unaligned count)."""
    if block is None:
        raise ValueError("the block stage needs block=(pre_state, signed_block, context)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device is available")

    from . import ops
    from .config import Context
    from .crypto import bls
    from .native import bls as native_bls
    from .ops import pairing as device_pairing
    from .ops.merkle import zero_hash_words
    from .parallel import make_chain_step, virtual_mesh
    from .parallel.pairing import batch_verify_sharded
    from .parallel.step import make_epoch_sweep_step, pad_registry_for_mesh, run_chain_step
    from .ssz import List, uint64
    from .telemetry import metrics

    t_all = time.monotonic()
    walls: dict = {}
    mesh = virtual_mesh(n_devices, device)
    n = validators

    with _stage(f"chain step (sharded merkle + psum, {n_devices} shards of {device})", walls):
        step = make_chain_step(mesh)
        rng = np.random.default_rng(7)
        balances = rng.integers(16 * 10**9, 40 * 10**9, size=n, dtype=np.uint64)
        eff = np.full(n, 32 * 10**9, dtype=np.uint64)
        active = np.ones(n, dtype=bool)
        new_eff, total, root = run_chain_step(step, mesh, balances, eff, active,
                                              zero_hash_words(mesh.devices[0]))
        expected = List[uint64, 2**40].hash_tree_root([int(b) for b in balances])
        got = root.astype(">u4").tobytes()
        _check(got == expected, f"sharded root {got.hex()} != host {expected.hex()}")
        _check(total == sum(int(e) for e in new_eff), "the sharded total is not the sum")

    with _stage("distributed epoch sweep (psum totals)", walls):
        sweep = make_epoch_sweep_step(mesh, Context.for_minimal())
        padded = pad_registry_for_mesh(n, n_devices)

        def pad(arr, dtype):
            out = np.zeros(padded, dtype)
            out[:len(arr)] = arr
            return out

        participation = rng.integers(0, 8, size=n, dtype=np.uint8)
        new_balances, _, total_active = sweep(
            pad(balances, np.uint64), pad(eff, np.uint64), pad(participation, np.uint8),
            pad(np.zeros(n, bool), np.bool_), pad(active, np.bool_), pad(active, np.bool_),
            pad(active, np.bool_), pad(np.zeros(n, np.uint64), np.uint64))
        _check(total_active == int(eff.sum()), f"epoch step total {total_active}")
        _check(new_balances.shape[0] == padded, "the epoch step's balances lost rows")

    with _stage("mesh-sharded signature-set aggregation", walls):
        n_sets, keys_per_set = 2 * n_devices, 4
        sks = [bls.SecretKey(1000 + i) for i in range(n_sets * keys_per_set)]
        raw_sets = [[sks[s * keys_per_set + j].public_key().raw_uncompressed()
                     for j in range(keys_per_set)] for s in range(n_sets)]
        agg = device_pairing.g1_sum_sets(raw_sets, mesh=mesh)
        for s, (got_raw, got_inf) in enumerate(agg):
            expected_pk = bls.eth_aggregate_public_keys(
                [sks[s * keys_per_set + j].public_key() for j in range(keys_per_set)])
            _check(not got_inf and native_bls.g1_compress_raw(got_raw) == expected_pk.to_bytes(),
                   f"set {s}: the sharded aggregate differs from the host's")

    with _stage("mesh-sharded RLC batch pairing (valid + tampered)", walls):
        n_sets_p = max(n_devices - 1, 2)  # >= 2 so that the tamper below indexes
        pkr, hr, sr, sc = [], [], [], []
        for i in range(n_sets_p):
            sk = bls.SecretKey(5000 + i)
            msg = b"p" * 31 + bytes([i])
            pkr.append(sk.public_key().raw_uncompressed())
            rc, raw, _ = native_bls.g2_decompress(
                native_bls.hash_to_g2_compressed(msg, bls.ETH_DST), check_subgroup=False)
            _check(rc == 0, f"hash_to_g2 of set {i} does not decompress")
            hr.append(raw)
            sr.append(sk.sign(msg).raw_uncompressed())
            sc.append(2 * i + 1)
        _check(batch_verify_sharded(pkr, hr, sr, sc, mesh=mesh) is True,
               "the sharded batch rejected valid sets")
        tampered = list(sr)
        tampered[1] = sr[0]
        _check(batch_verify_sharded(pkr, hr, tampered, sc, mesh=mesh) is False,
               "the sharded batch accepted a tampered set")

    with _stage("full signed block, device-routed == host root", walls):
        from .models.altair.state_transition import state_transition

        state, signed, ctx = block
        host_state = state.copy()
        state_transition(host_state, signed, ctx)
        host_root = type(host_state).hash_tree_root(host_state)
        engaged = metrics.counter("mesh.engage.pairing")
        before = engaged.value()
        # ECT_MESH=1: the block's batched signature sets take the mesh route
        # (crypto/bls.py, the sharded pairing) on one shard of the device
        with _mesh_switch("1"):
            ops.install(device=device, sweeps_min_n=1, shuffle_min_n=1 << 60,
                        bls_agg_min_n=1, pairing_min_sets=1)
            try:
                dev_state = state.copy()
                state_transition(dev_state, signed, ctx)
                dev_root = type(dev_state).hash_tree_root(dev_state)
            finally:
                ops.uninstall()
        pairing_engaged = engaged.value() - before
        _check(dev_root == host_root, f"device-routed block application diverged: "
               f"{dev_root.hex()} != {host_root.hex()}")
        _check(pairing_engaged > 0, "the block's signature batch did not take the mesh route")

    summary = {
        "n_devices": n_devices, "device": str(device), "validators": n, "padded": padded,
        "root": got.hex(), "total_active": total, "epoch_sweep_total": total_active,
        "sets": n_sets, "keys_per_set": keys_per_set, "pairing_sets": n_sets_p,
        "block_slot": int(signed.message.slot),
        "attestations": len(signed.message.body.attestations),
        "block_root": dev_root.hex(), "pairing_engaged": pairing_engaged,
        "stages_s": walls, "total_s": time.monotonic() - t_all,
    }
    print(f"dryrun_multichip ok: {n_devices} shards of {device}, n={n} (padded {padded}), "
          f"root={got.hex()[:16]}…, total_active={total}, "
          f"epoch_sweep_total={total_active}, sharded_set_agg={n_sets}x{keys_per_set} ok, "
          f"sharded_pairing={n_sets_p} sets ok, block@{summary['block_slot']} with "
          f"{summary['attestations']} atts + sync aggregate: device==host root "
          f"{dev_root.hex()[:16]}…, total {summary['total_s']:.1f}s", flush=True)
    return summary
