"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py            # from the repository root, on a CUDA machine

Phases, each of which exits non-zero when it fails:
  1. device  — require CUDA; print the card's name and power limit.
  2. build   — compile every kernel in ethereum_consensus_tpu_torch/csrc.
  3. kernel  — the SHA-256 kernel against its plain PyTorch version on the
               card, bit-exact, for N in {1, 1000, 1024, 1025, 2^22}, a sample
               against hashlib; CUDA-event times at N = 2^17 .. 2^22.
  4. htr     — the device merkleizer on 2^20 random chunks against the host
               merkleizer.
  5. slice   — a mainnet-preset phase0 BeaconState of 2^20 validators,
               serialized and read back twice; process_slots to slot 3 with
               the CUDA hasher installed and without it must give identical
               bytes and roots, and the kernel must have been launched.
Then one JSON line per kernel (``{"kernels": [...]}``) and, last, the
``{"ok": true, "device": ...}`` line.

Imports only the port, torch, numpy and the standard library.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data-sheet rates: device memory bandwidth, and INT32 issue at 64
# lanes per SM per clock at the 1,980 MHz boost clock (a quarter of the
# 67 TFLOP/s FP32 rate: 128 FP32 lanes per SM, two operations per FMA).
MEM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
BOOST_CLOCK_HZ = 1.98e9

# 32-bit integer operations of one 64-byte message: two compressions of 64
# rounds at 14 operations each (one funnel shift per rotate, one LOP3 per
# three-input logic op, one IADD3 per three-input add), 8 feed-forward adds
# per compression, and 48 schedule steps of 10 for the message block (the
# pad block's schedule is constant).
SHA256_OPS_PER_MESSAGE = 2 * (64 * 14 + 8) + 48 * 10
SHA256_BYTES_PER_MESSAGE = 64 + 32

KERNEL_CHECK_NS = (1, 1000, 1024, 1025, 1 << 22)
KERNEL_TIME_LOG2 = range(17, 23)  # the routed levels of the 2^20 cold walk
HTR_LOG2_LEAVES = 20
VALIDATORS = 1 << 20
SLOTS = 3


def _random_words(n: int, gen: torch.Generator) -> torch.Tensor:
    return torch.randint(-(2**31), 2**31, (16, n), dtype=torch.int32,
                         device="cuda", generator=gen)


def _cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` on the card, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sha256_bound_ms(n: int) -> tuple[float, str]:
    """Least time the card could take for n messages, and what sets it."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ops_ms = 1e3 * n * SHA256_OPS_PER_MESSAGE / (sms * INT32_LANES_PER_SM * BOOST_CLOCK_HZ)
    bytes_ms = 1e3 * n * SHA256_BYTES_PER_MESSAGE / MEM_BYTES_PER_S
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def phase_device() -> dict:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return {"nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> dict:
    from ethereum_consensus_tpu_torch import _kernels, native

    seconds = _kernels.build_all()
    print(f"build: {seconds:.3f} s")
    log = _kernels.build_log("sha256")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    # the host rung, built here so that no timed host path pays for g++
    t0 = time.perf_counter()
    if not native.available():
        sys.exit("chip_smoke: the host SHA-256 backend needs g++")
    native_s = time.perf_counter() - t0
    print(f"native host build: {native_s:.3f} s")
    return {"build_s": seconds, "native_build_s": native_s}


def _hashlib_sample_ok(words: torch.Tensor, digests: torch.Tensor, gen) -> bool:
    n = words.shape[1]
    idx = torch.unique(torch.cat([
        torch.tensor([0, n - 1]),
        torch.randint(0, n, (64,), generator=gen, device="cuda").cpu(),
    ]))
    msgs = words[:, idx.cuda()].cpu().numpy().view(np.uint32).T.astype(">u4")
    got = digests[:, idx.cuda()].cpu().numpy().view(np.uint32).T.astype(">u4")
    return all(
        hashlib.sha256(m.tobytes()).digest() == d.tobytes() for m, d in zip(msgs, got)
    )


def phase_kernel() -> dict:
    from ethereum_consensus_tpu_torch.ops import sha256

    gen = torch.Generator(device="cuda").manual_seed(20261016)
    checks = []
    for n in KERNEL_CHECK_NS:
        words = _random_words(n, gen)
        got = sha256.sha256_64b(words)
        torch.cuda.synchronize()
        plain = sha256.sha256_64b_plain(words)
        err = int((got.to(torch.int64) - plain.to(torch.int64)).abs().max().item())
        sample_ok = _hashlib_sample_ok(words, got, gen)
        print(f"kernel N={n}: max_abs_err vs plain {err}, hashlib sample ok {sample_ok}")
        if err != 0 or not sample_ok:
            sys.exit(f"chip_smoke: SHA-256 kernel disagrees at N={n}")
        checks.append({"n": n, "max_abs_err": err})
    timings = []
    for log2 in KERNEL_TIME_LOG2:
        n = 1 << log2
        words = _random_words(n, gen)
        ms = _cuda_ms(lambda: sha256.sha256_64b_cuda(words), reps=20)
        bound, bound_by = sha256_bound_ms(n)
        timings.append({"log2_n": log2, "n": n, "ms": ms, "bound_ms": bound,
                        "bound_by": bound_by})
        print(f"kernel N=2^{log2}: {ms:.4f} ms (bound {bound:.4f} ms by {bound_by})")
    n = 1 << 22
    words = _random_words(n, gen)
    plain_ms = _cuda_ms(lambda: sha256.sha256_64b_plain(words), reps=3, warmup=1)
    print(f"plain N=2^22: {plain_ms:.3f} ms")
    return {"checks": checks, "timings": timings, "plain_ms_2p22": plain_ms,
            "max_abs_err": max(c["max_abs_err"] for c in checks)}


def phase_htr(log2_leaves: int) -> dict:
    from ethereum_consensus_tpu_torch import ops
    from ethereum_consensus_tpu_torch.ops import sha256
    from ethereum_consensus_tpu_torch.ssz.merkle import merkleize_chunks

    ops.uninstall()
    n = 1 << log2_leaves
    chunks = np.random.default_rng(42).bytes(32 * n)
    sha256.launch_count = 0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        device_root = ops.merkleize_chunks_device(chunks, device="cuda")
        times.append(time.perf_counter() - t0)
    launches = sha256.launch_count // 3
    t0 = time.perf_counter()
    host_root = merkleize_chunks(chunks)
    host_s = time.perf_counter() - t0
    print(f"htr 2^{log2_leaves} leaves: device {statistics.median(times):.4f} s "
          f"(first {times[0]:.4f} s, {launches} launches), host {host_s:.4f} s, "
          f"roots equal {device_root == host_root}")
    if device_root != host_root or launches == 0:
        sys.exit("chip_smoke: device merkle root disagrees with the host root")
    return {"leaves": n, "device_s": statistics.median(times), "device_first_s": times[0],
            "host_s": host_s, "launches": launches}


def _synthetic_pubkey(index: int) -> bytes:
    """48 bytes that never decompress as a BLS key (leading 0xff)."""
    return (b"\xff" + hashlib.sha256(b"synthetic-pk" + index.to_bytes(8, "little")).digest()[:15]
            + index.to_bytes(32, "big"))


def build_registry_state(validators: int):
    """A phase0 mainnet-preset state of ``validators`` active validators,
    built directly (no deposits): the registry every slot hashes."""
    from ethereum_consensus_tpu_torch.config import Context
    from ethereum_consensus_tpu_torch.models.phase0 import build
    from ethereum_consensus_tpu_torch.primitives import FAR_FUTURE_EPOCH, GENESIS_EPOCH

    ctx = Context.for_mainnet()
    ns = build(ctx.preset)
    eth1_block_hash = b"\x42" * 32
    state = ns.BeaconState(
        genesis_time=1578009600 + ctx.genesis_delay,
        fork=ns.Fork(previous_version=ctx.genesis_fork_version,
                     current_version=ctx.genesis_fork_version, epoch=GENESIS_EPOCH),
        eth1_data=ns.Eth1Data(block_hash=eth1_block_hash, deposit_count=validators),
        latest_block_header=ns.BeaconBlockHeader(
            body_root=ns.BeaconBlockBody.hash_tree_root(ns.BeaconBlockBody())
        ),
        randao_mixes=[eth1_block_hash] * ctx.EPOCHS_PER_HISTORICAL_VECTOR,
        eth1_deposit_index=validators,
    )
    state.validators = [
        ns.Validator(
            public_key=_synthetic_pubkey(i),
            withdrawal_credentials=b"\x00"
            + hashlib.sha256(b"wc" + i.to_bytes(8, "little")).digest()[1:],
            effective_balance=ctx.MAX_EFFECTIVE_BALANCE,
            activation_eligibility_epoch=GENESIS_EPOCH,
            activation_epoch=GENESIS_EPOCH,
            exit_epoch=FAR_FUTURE_EPOCH,
            withdrawable_epoch=FAR_FUTURE_EPOCH,
        )
        for i in range(validators)
    ]
    state.balances = [ctx.MAX_EFFECTIVE_BALANCE] * validators
    state.genesis_validators_root = type(state).__ssz_fields__[
        "validators"
    ].hash_tree_root(state.validators)
    return state, ctx


def phase_slice(validators: int, slots: int) -> dict:
    from ethereum_consensus_tpu_torch import convert, ops
    from ethereum_consensus_tpu_torch.models.phase0 import slot_processing
    from ethereum_consensus_tpu_torch.ops import sha256
    from ethereum_consensus_tpu_torch.ssz import hash as ssz_hash

    t0 = time.perf_counter()
    state, ctx = build_registry_state(validators)
    state_type = type(state)
    data = state_type.serialize(state)
    del state
    device_state = convert.state_from_ssz(data, ctx.preset)
    host_state = convert.state_from_ssz(data, ctx.preset)
    timed_state = convert.state_from_ssz(data, ctx.preset)
    setup_s = time.perf_counter() - t0
    print(f"slice: {validators} validators, {len(data)} state bytes, set-up {setup_s:.1f} s")

    # the main path: slots with the CUDA hasher, launches counted from 0
    ops.install(device="cuda")
    sha256.launch_count = 0
    t0 = time.perf_counter()
    slot_processing.process_slots(device_state, slots, ctx)
    device_slots_s = time.perf_counter() - t0
    launches = sha256.launch_count

    ops.uninstall()
    t0 = time.perf_counter()
    slot_processing.process_slots(host_state, slots, ctx)
    host_slots_s = time.perf_counter() - t0

    device_bytes = state_type.serialize(device_state)
    same_bytes = device_bytes == state_type.serialize(host_state)
    device_root = state_type.hash_tree_root(device_state)
    same_root = device_root == state_type.hash_tree_root(host_state)
    print(f"slice: process_slots to {slots}: device {device_slots_s:.3f} s "
          f"({launches} launches), host {host_slots_s:.3f} s, bytes equal {same_bytes}, "
          f"roots equal {same_root}, root {device_root.hex()}")
    if not (same_bytes and same_root) or launches == 0:
        sys.exit("chip_smoke: the slice disagrees with the host path or never launched")

    # bench.py's state_htr pattern: cold, warm and one-validator-edit roots.
    # Each routed level is timed whole (host conversion, copies, kernel).
    routed = []

    def timed_level(nodes: bytes) -> bytes:
        t0 = time.perf_counter()
        out = sha256.hash_level_bytes(nodes, device="cuda")
        routed.append((len(nodes) // 64, time.perf_counter() - t0))
        return out

    ssz_hash.register_device_hasher(timed_level)
    sha256.launch_count = 0
    digests = ssz_hash.digest_count()
    t0 = time.perf_counter()
    cold_root = state_type.hash_tree_root(timed_state)
    cold_s = time.perf_counter() - t0
    cold_launches = sha256.launch_count
    cold_digests = ssz_hash.digest_count() - digests
    cold_routed = list(routed)
    t0 = time.perf_counter()
    state_type.hash_tree_root(timed_state)
    warm_s = time.perf_counter() - t0
    timed_state.validators[validators // 2].effective_balance = 31 * 10**9
    t0 = time.perf_counter()
    state_type.hash_tree_root(timed_state)
    edit_s = time.perf_counter() - t0
    ops.uninstall()
    routed_s = sum(sec for _n, sec in cold_routed)
    print(f"slice: cold root {cold_s:.3f} s ({cold_launches} launches, {cold_digests} digests), "
          f"warm {warm_s:.4f} s, one-validator edit {edit_s:.4f} s")
    print(f"slice: cold root routed levels (parent nodes, s): "
          f"{[(n, round(sec, 4)) for n, sec in cold_routed]}, {routed_s:.3f} s in all")
    # the host path's first slot stored the same state's root at state_roots[0]
    if cold_root != host_state.state_roots[0]:
        sys.exit("chip_smoke: the cold device root disagrees with the host root")
    return {"validators": validators, "state_bytes": len(data), "setup_s": setup_s,
            "slots": slots, "device_slots_s": device_slots_s, "host_slots_s": host_slots_s,
            "launches": launches, "cold_root_s": cold_s, "cold_root_launches": cold_launches,
            "cold_root_digests": cold_digests, "cold_root_routed": cold_routed,
            "cold_root_routed_s": routed_s, "warm_root_s": warm_s,
            "one_validator_edit_s": edit_s}


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)
    report = {"device": phase_device()}
    report["build"] = phase_build()
    report["kernel"] = phase_kernel()
    report["htr"] = phase_htr(HTR_LOG2_LEAVES)
    report["slice"] = phase_slice(VALIDATORS, SLOTS)

    kernel = report["kernel"]
    at_2p22 = next(t for t in kernel["timings"] if t["log2_n"] == 22)
    kernels = {"kernels": [{
        "name": "sha256_64b",
        "route": "cuda",
        "source": "ethereum_consensus_tpu_torch/csrc/sha256.cu",
        "replaces": "ethereum_consensus_tpu/ops/sha256.py:197",
        "launches": report["slice"]["launches"],
        "max_abs_err": kernel["max_abs_err"],
        "ms": at_2p22["ms"],
        "plain_ms": kernel["plain_ms_2p22"],
        "bound_ms": at_2p22["bound_ms"],
        "bound_by": at_2p22["bound_by"],
        "library_ms": None,
    }]}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": report["device"]["kind"],
        "count": report["device"]["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
