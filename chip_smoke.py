"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py            # from the repository root, on a CUDA machine

Phases, each of which exits non-zero when it fails:
  1. device   — require CUDA; print the card's name and power limit.
  2. build    — compile every kernel in ethereum_consensus_tpu_torch/csrc
                (one nvcc per library, all at once: the mxu builds of
                g1_sum.cu and pairing.cu beside the u64 ones) and the two
                native host libraries (SHA-256, BLS12-381) beside them.
     mxu      — B8 alone: the int8 tensor-core Montgomery product
                (fq8.mont7r) over 2^20 seeded pairs, bit-exact against
                fq.mul and the plain mont7r on the card, and at 2^15 and the
                tile edges (1, 15, 16, 17, 2^10 + 3 products); CUDA-event
                times at 2^20 and 2^15, an empty launch and torch._int_mm of
                the m p GEMM as yardsticks; ptxas' lines of B8 and the mxu
                builds (a frame or spill in B8, or a spill or frame in an mxu
                build beyond MXU_PTXAS_CEILINGS, fails it).
  3. sha256   — the SHA-256 kernel against its plain PyTorch version on the
                card, bit-exact, for N in {1, 1000, 1024, 1025, 2^22}, a
                sample against hashlib; CUDA-event times at N = 2^17 .. 2^22.
  4. registry — a mainnet-preset phase0 BeaconState of 2^20 validators; the
                keys of slot 0's 64 committees and of the slot-2 proposer are
                made real (SecretKey(i + 1)); serialized once.
  5. shuffle  — the committee-shuffle kernel against its plain version, 90
                rounds, count in {1, 255, 256, 257, 2^15, 2^20} and 2^21 + 5
                (a row larger than one SM's shared memory), bit-exact, a
                sample against the spec's compute_shuffled_index; CUDA-event
                times at 2^15, 2^20 and 2^21 + 5; ptxas' lines of the kernel.
  6. g1       — the G1 set-sum kernel (two grid launches: the lanes' chains,
                then the fold) against its plain version, limb for limb: the
                edge sets (infinity lane, doubling, P + -P, only infinity,
                empty, ragged), one set of 2^15 keys, and the block's 66 sets
                of 32,770 keys; some sums against the native aggregation;
                CUDA-event times at each shape, ptxas' lines of both kernels.
                Its mxu build (fq8.set_multiplier("mxu")) limb for limb
                against the u64 kernel on the edge and block sets and against
                the plain version under mxu on the edge sets.
  7. htr      — the multi-level merkle kernel (B2) against its plain version
                on the card and the host merkleizer, bit-exact, at 2^20
                leaves without and with the limit 2^40, at 2^20 - 3, 1, 3
                and 2^17 + 1 leaves, from start_level 3, and at 2^15 leaves
                and limit 2^40 (two launches at most); its CUDA-event times at
                2^20 and 2^15 leaves, limit 2^40, each beside its bound and
                its latency floor (the tree's 40 dependent messages at one
                thread's clock64 latency of a message), the first beside the
                per-level B1 chain it replaced; ptxas' lines of the kernel;
                then the device merkleizer on 2^20 random chunks against the
                host merkleizer, its wall split into byte conversion, upload,
                kernels and the root's way back.
  8. slice    — process_slots to slot 3 with the CUDA hasher installed and
                without it must give identical bytes and roots, and the
                SHA-256 kernel must have been launched.
  9. block    — a signed slot-2 block with 64 attestations applied with
                Executor.apply_block on the host path and after
                ops.install(device="cuda"): identical post-state bytes and
                roots, each kernel launched; the block with attestation 17's
                signature replaced by attestation 18's raises the same error
                on both paths.
     telemetry — the three staged epoch kernels (csrc/epoch_staged.cu:
                the inactivity update, one flag's deltas, four delta pairs
                applied in order) through epoch_vector.jitted_kernels() at
                2^20 and 2^20 + 5 on seeded columns with u64 edge rows
                (adds that wrap, reward products past 2^64, penalties that
                saturate, scores at 0, 1, the recovery rate and far above,
                leaking and not, head flag and not), bit-exact against their
                plain versions on the card, each launched; CUDA-event times
                at 2^20 beside bounds and plain versions. Then the block
                phase's block applied cold on the device path from SSZ twice:
                once plain, once with spans recording and the device and
                memory observatories on: the same post-state root, every
                phases.attribution bucket present and adding up, the launch
                ledger equal to the launch counts kernel by kernel, every
                transfer site with its bytes, the route tallies equal to the
                device.route.* counters, a device lane in the Chrome trace
                (written to chiprun_out/telemetry_trace.json; its summary
                printed); both walls printed against the prediction; the
                memory census of the recorded 2^20 state timed apart.
 10. sweeps   — the effective-balance hysteresis kernel against its plain
                version, bit-exact, for n in {1, 255, 256, 257, 2^17, 2^20}
                and one and two rows in (threshold crossings both ways,
                thresholds +-1, words at and above 2^63), a sample against
                Python integers; CUDA-event time at 2^20 beside a copy of its
                bytes and an empty launch; ptxas and SASS (a frame or a
                spill fails it).
 11. epoch    — the registry state taken to slot 64, a few thousand
                validators scrambled (hysteresis crossings, ejections,
                slashings at the halfway point, entrants), advanced to slot
                95 with full pending attestations for epochs 1 and 2, then
                the boundary into epoch 3 crossed on the host path (the
                columnar engine) and after ops.install(device="cuda") (the
                literal stages, hysteresis on the card): identical bytes and
                roots, the sweeps kernel launched once, SHA-256 at least
                once, some effective balances changed.
 12. altair_sweeps — the fused epoch kernel (B3) and the three altair sweep
                kernels (flag deltas, inactivity updates and penalties)
                against their plain versions, bit-exact, for n in {1, 255,
                256, 257, 2^17, 2^20} (mixed flags, slashed and ineligible
                lanes, scores near the thresholds, words at and above 2^63
                whose products wrap), samples against Python integers; the
                flag deltas and B3 (its census too) also at 2^21 + 5,
                contiguous and one validator in, the inactivity updates one
                and two rows in; CUDA-event times at 2^20; ptxas' registers,
                frame and spills of the updates, the penalties, B3, its
                apply entries and K3 (a frame or a spill fails the run) and
                their SASS instructions.
     sums     — K2 and the B9-epoch flag sums (csrc/masked_sums.h's kernel
                at four and three sums) against their plain versions,
                bit-exact, at 2^20, 2^18, 2^21 + 5, one validator and none
                (seeded words over the whole u64 range: the sums wrap) and
                on a view one row in; CUDA-event times at 2^20 and 2^18; the
                timer's floor (an empty launch); ptxas' registers, frame and
                spills of both builds (a frame or a spill fails the run).
 13. altair   — the registry to slot 32 under phase0 rules, the sync
                committee's keys made real, upgrade_to_altair (altair at
                epoch 1), slots to 95 under altair rules, a scramble of a
                few thousand validators with seeded participation flags of
                epochs 1 and 2 and inactivity scores, then a signed block at
                slot 96 (64 aggregates over slot 95's committees and a full
                sync aggregate) through Executor.apply_block on the host
                path (the columnar engine), after ops.install(device="cuda")
                (the engine with the fused epoch kernel) and on the literal
                device route (ECT_EPOCH_VECTOR=off: the three altair sweep
                kernels and hysteresis): identical bytes and roots, the
                launches of each route checked, some balances, scores and
                effective balances changed, and the block with its
                sync-aggregate signature replaced rejected alike on the host
                and device paths. Then the capella cell (the state at slot 64
                upgraded to bellatrix and capella, capella's rules to 95, a
                block with 16 withdrawals past the registry's end and 16
                BLS-to-execution changes) and the deneb cell (the capella
                state at slot 64 upgraded to deneb, deneb's rules to 95, a
                block with six blob commitments besides capella's
                operations), each on the host and device paths with identical
                bytes and roots and the device path's launches checked; the
                capella block with a changed withdrawal and the deneb block
                with a seventh commitment rejected alike; the deneb boundary
                activating exactly EIP-7514's cap; then the node's
                data-availability check of the deneb block's six blob
                sidecars on the host's native library (the inclusion proofs,
                one KZG batch verification): true, and false with one field
                element of a blob or one node of a proof changed. Then the
                electra cell (the deneb state at slot 64 upgraded to electra,
                electra's rules to 95, the scramble and EIP-7251's work:
                pending deposits, ripe, slashed and unripe pending
                consolidations, 0x02 validators of 33 to 2,100 ETH, pending
                partial withdrawals; a block with two committee-spanning
                aggregates of 32,768 signers, 16 deposit receipts, 16
                withdrawal requests and a consolidation besides deneb's
                operations) on the host and device paths, identical bytes and
                roots, the boundary's and the block's counts checked, the
                block with its consolidation signed by the source alone
                refused alike; then B6 alone at that block's sets.
 14. pairing  — the four batched-pairing kernels (G1 blinder
                multiplication with the affine conversion, G2 blinder
                multiplication with the sum, the Miller loop, the Fq12
                product) against their plain versions on the card,
                bit-exact, for n in {1, 2, 3, 64, 528} on a seeded batch of
                signed sets; the Miller values of every lane against the
                native miller_loop_raw; the 528-set verdict against the native
                batch verification, a tampered set rejected by both;
                CUDA-event times
                at the window's shapes (528 lanes, 529 for the Miller loop
                and the product), at one lane (a lane's latency; the
                product at two values) and for G1 at blinder 1 (its
                inversion alone); ptxas' lines of their crew kernels
                (pairing_lanes.h). Their mxu builds bit-exact
                against the u64 kernels at every n, against the plain
                versions under mxu at n = 3 (timed on that call), all 528
                Miller lanes against the native ones; CUDA-event times at
                528 lanes.
 15. window   — eight signed blocks at slots 2..9 on the registry state
                (each with the 64 full aggregates of one slot of epoch 0;
                those 262,144 attesters' keys made real) applied through
                Executor.apply_block_with_validation under defer_flushes
                after ops.install(device="cuda") (its launches kept for the
                pipeline phase),
                then their 528 sets verified by one verify_signature_sets
                call on the host route, after ops.install(device="cuda")
                (the device pairing from 512 sets on) and on that device
                route with fq8.set_multiplier("mxu"): every verdict true on
                all three, the same blame for a copy with one aggregate's
                signature replaced by its neighbour's, and B6 and each B7
                kernel launched on the device route, their mxu builds and
                none of the u64 ones on the mxu route (a count is one per
                grid launch: B6 twice, its chains and its fold; the B7
                folds' further launches included; the Miller loop once, the
                extra pair its lane 528); then B6 alone at the window's 528
                sets, against its plain version and its mxu build.
     pipeline — the chain pipeline on the window's eight blocks: the
                pre-state read from SSZ, ops.install(device="cuda"), then
                Executor.stream(blocks, FlushPolicy(window_size=8,
                max_in_flight=2, verify_lanes=1)) with the flight recorder
                on: the window phase's post-state root; one window of 528
                sets on the device route, no retry, degradation or worker
                death; the launch ledger equal to the launch counts, B1 and
                B4 as the window phase's loop (on the main thread), B6 2,
                g1_mul_affine 1, g2_mul_sum 3, miller_loop 1, fp12_product 2
                (on the verifier's thread); the stream's wall, stage A and
                stage B busy, the submitter's settle wait and the window's
                verify seconds printed beside the window phase's loop and
                device verification. Then, untimed, the stream again from the
                SSZ with block 3's proposer signature replaced by block 2's:
                it raises what Executor.apply_block raises for that block,
                the executor's root is block 2's state root, a further
                submit raises PipelineBrokenError, the window went to the
                device and its blame is block 3's proposer set alone.
     serve    — the read plane (serving/, proofs/) over HTTP on the
                tampered stream's committed head: eight Beacon-API requests
                cold and warm, and a 128-validator multiproof on the host
                route and under ECT_MESH=1 (its columnar rebuild on B1).
     pool     — the write plane (pool/) on that head under
                ops.install(device="cuda"): 512 gossip-shaped aggregates of
                8 committees in one POST through the RLC window (one flush,
                8 fused groups) and the scalar twin on the same messages,
                timed; the six spam lanes' reasons; the served view against
                the scalar pool, both selections, the census's pool.store
                owner; produce_block at slot 5 from the pool (its replay's
                flush on B6), timed and split; its publication over HTTP
                through an Executor, the served head root the block's; B6
                alone at the replay's sets against its plain version.
 16. mesh     — the ECT_MESH route (parallel/, the reference's production
                mesh switch) at ECT_MESH=1: the altair phase's block applied
                cold through Executor.apply_block after ops.install(device=
                "cuda") — the sharded fused epoch pass (B3's flag sums, their
                psum, B3's element pass) and the sharded state roots (B2 per
                shard, then from start_level over the gathered roots) — with
                the altair routes' post-state bytes and root, the epoch and
                merkle twins engaged; the window's 528 sets on the sharded RLC
                route (B7 per shard, the partials folded by B7): every verdict
                true, the host route's blame, the pairing twin engaged. Then
                each twin at virtual_mesh(4, "cuda") and chip_mesh(1) on the
                inputs those runs gave it: the largest sharded root against
                the host root; the three MeshEpochSweeps entries (with u64
                edge rows) against the unsharded B3 and B5-altair kernels and
                their plain versions, and the wrap census; the pairing
                partials against the unsharded route, limb for limb, the
                verdict, and a blinder-0 lane. CUDA-event times of B3's split
                launches and the rewards lane at 2^20; each twin's wall.
                ECT_MESH=2 on the one card must raise.
 17. step     — the sharded chain step and epoch sweep step (parallel/step.py,
                the reference's graft-entry chain step) at 2^20 validators,
                on chip_mesh(1) and virtual_mesh(4, "cuda"): the chain step
                at 2^20 and 2^20 + 5 with u64 edge rows (root against the host
                SSZ root of List[uint64, 2^40], total against numpy, new
                effective balances against the hysteresis kernel), the
                epoch step on the altair_sweeps columns with u64 edge rows
                (against the host columnar kernels of models/epoch_vector.py
                and the plain step, leaking and not; the score bound's
                OverflowError); the three shard kernels (chain_step_shard,
                epoch_step_sums, epoch_step_apply) bit-exact against their
                plain versions at 2^20, CUDA-event times; each step's wall;
                then the graft twin (graft_entry.py): entry("cuda")'s root
                against the host merkleizer, and dryrun_multichip(4, "cuda")
                with a 2^13-validator minimal altair block built here (16
                aggregates, a full sync aggregate), every stage checked and
                the block's device-routed root equal to the host root.
Around every CUDA-event timing the card's SM clock and active throttle
reasons are printed (read through NVML, the library nvidia-smi uses).
Then the run's wall time, one JSON
line per kernel (``{"kernels": [...]}``) and, last, the
``{"ok": true, "device": ...}`` line.

Imports only the port, torch, numpy and the standard library.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import gc
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM rates: device memory bandwidth from the data sheet, and integer
# dispatch at 128 lanes per SM per clock at the 1,980 MHz boost clock: four
# schedulers each dispatch one 32-lane warp instruction a clock, the most
# any mix of instructions can reach (the INT32 pipe alone has 64 lanes;
# integer multiply-adds go to the FMA pipe beside it).
MEM_BYTES_PER_S = 3.35e12
DISPATCH_LANES_PER_SM = 128
BOOST_CLOCK_HZ = 1.98e9
# Kernel timing (_cuda_ms): twice the H100's 50 MB L2, and a spin of about
# 0.5 ms, longer than the host takes to enqueue one timed call.
L2_FLUSH_BYTES = 100 << 20
SPIN_CYCLES = 1_000_000

# 32-bit integer operations of one 64-byte message: two compressions of 64
# rounds at 14 operations each (one funnel shift per rotate, one LOP3 per
# three-input logic op, one IADD3 per three-input add), 8 feed-forward adds
# per compression, and 48 schedule steps of 10 for the message block (the
# pad block's schedule is constant).
SHA256_OPS_PER_MESSAGE = 2 * (64 * 14 + 8) + 48 * 10
SHA256_BYTES_PER_MESSAGE = 64 + 32
# Integer operations of one index in one shuffle round: the 64-bit flip and
# its conditional subtraction, the max, the byte address, the bit test and
# the select.
SHUFFLE_OPS_PER_INDEX_ROUND = 12
# 32x32->64-bit multiply-adds (one IMAD.WIDE each) of one Fp operation on
# 12 limbs: a multiplication takes 144 for the product and 144 for the
# Montgomery reduction, a squaring 78 for the product (each cross term
# once, then doubled) and 144 for the reduction. Adding an affine key to a
# Jacobian sum is a mixed addition (madd-2007-bl): 7 multiplications and 4
# squarings.
FP_MUL_MADS = 288
FP_SQR_MADS = 78 + 144
G1_MIXED_ADD_MADS = 7 * FP_MUL_MADS + 4 * FP_SQR_MADS
# B8 alone: the products of the mxu phase, and the bytes of one product;
# the smaller batch and the tile edges it is also held at; the widths of the
# torch._int_mm yardstick (the m p GEMM at 120 columns, which cuBLASLt has
# refused on the H100; the kernel's 112; and 128, the next multiple of 16)
MXU_PAIRS = 1 << 20
MXU_SMALL_PAIRS = 1 << 15
MXU_TILE_EDGES = (1, 15, 16, 17, (1 << 10) + 3)
MXU_YARDSTICK_COLUMNS = (120, 112, 128)
MONT_BYTES = 3 * 48
# 32-bit integer operations of one validator's hysteresis update: two
# 64-bit adds and unsigned compares (2 + 2 each) and their OR, the 64-bit
# remainder by a divisor fixed for the whole sweep as a Barrett reduction
# with a precomputed reciprocal (a 64x64 -> high 64 product in 4
# multiply-adds and 4 adds, the product back in 3, a 64-bit subtraction
# and one conditional correction of 4), the subtraction, the 64-bit min
# (compare and select, 4) and the final select (2). Bytes: two words read,
# one written.
SWEEPS_OPS_PER_VALIDATOR = 9 + 8 + 3 + 2 + 4 + 2 + 4 + 2
SWEEPS_BYTES_PER_VALIDATOR = 24

KERNEL_CHECK_NS = (1, 1000, 1024, 1025, 1 << 22)
KERNEL_TIME_LOG2 = range(17, 23)  # the routed levels of the 2^20 cold walk
SHUFFLE_CHECK_COUNTS = (1, 255, 256, 257, 1 << 15, 1 << 20)
# beside them: a count whose row (256 KB) is larger than an SM's shared memory
SHUFFLE_WIDE_COUNT = (1 << 21) + 5
SHUFFLE_MAIN_COUNT = 1 << 20  # the main path's: the registry's
SHUFFLE_ROUNDS = 90
# grid launches of one B6 call (u64): the lanes' chains, then the fold
G1_SUM_LAUNCHES = 2
SWEEPS_CHECK_NS = (1, 255, 256, 257, 1 << 17, 1 << 20)
HTR_LOG2_LEAVES = 20
VALIDATORS = 1 << 20
SLOTS = 3
BLOCK_SLOT = 2
TAMPERED_ATTESTATION = 17
EPOCH_SCRAMBLE_SLOT = 64
EPOCH_PRE_SLOT = 95  # the last slot of epoch 2; the boundary into epoch 3 follows


def _random_words(n: int, gen: torch.Generator) -> torch.Tensor:
    return torch.randint(-(2**31), 2**31, (16, n), dtype=torch.int32,
                         device="cuda", generator=gen)


# NVML, the library nvidia-smi reads the card through: (library, the card's
# handle, the reasons function) once loaded. A reading is a library call,
# not a process: a whole run reads the clocks around some 160 timings. The
# reasons function goes by its newer name where the driver exports it.
_NVML: list = []
NVML_CLOCK_SM = 1


def _nvml() -> tuple:
    if not _NVML:
        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
            reasons = getattr(lib, "nvmlDeviceGetCurrentClocksEventReasons", None) or \
                lib.nvmlDeviceGetCurrentClocksThrottleReasons
        except (OSError, AttributeError) as exc:
            sys.exit(f"chip_smoke: NVML cannot be loaded to read the card's clocks: {exc}")
        lib.nvmlDeviceGetHandleByIndex_v2.argtypes = [ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]
        lib.nvmlDeviceGetClockInfo.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                               ctypes.POINTER(ctypes.c_uint)]
        reasons.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]
        for fn in (lib.nvmlInit_v2, lib.nvmlDeviceGetHandleByIndex_v2,
                   lib.nvmlDeviceGetClockInfo, reasons):
            fn.restype = ctypes.c_int
        handle = ctypes.c_void_p()
        status = lib.nvmlInit_v2() or lib.nvmlDeviceGetHandleByIndex_v2(0, ctypes.byref(handle))
        if status:
            sys.exit(f"chip_smoke: NVML refused the card (status {status})")
        _NVML.append((lib, handle, reasons))
    return _NVML[0]


def _clocks() -> str:
    """The card's SM clock and active throttle reasons (a bit mask, 0 for
    none), read through NVML; the run fails where a reading fails."""
    lib, handle, reasons_fn = _nvml()
    clock, reasons = ctypes.c_uint(), ctypes.c_ulonglong()
    status = lib.nvmlDeviceGetClockInfo(handle, NVML_CLOCK_SM, ctypes.byref(clock)) or \
        reasons_fn(handle, ctypes.byref(reasons))
    if status:
        sys.exit(f"chip_smoke: NVML did not read the card's clocks (status {status})")
    return f"{clock.value} MHz, 0x{reasons.value:016x}"


def _cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of one call of ``fn`` on the card, from CUDA
    events. Each call is enqueued behind a spin kernel, so the host's time
    to launch it opens no gap between the start event and the kernel (a
    kernel of a few microseconds would otherwise time the host), and behind
    a write of twice the L2 cache, so it reads its inputs from device
    memory. The SM clock and throttle reasons are printed before and after."""
    before = _clocks()
    for _ in range(warmup):
        fn()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    print(f"  clocks (MHz, throttle reasons) before: {before}; after: {_clocks()}")
    return statistics.median(times)


def _yardsticks(nbytes: int) -> tuple:
    """Milliseconds of a PyTorch copy of ``nbytes`` bytes (half read, half
    written: the bytes a sweep moves) and of an empty launch, both on
    ``_cuda_ms``: what a byte-bound kernel of those bytes is held to."""
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = _cuda_ms(lambda: dst.copy_(src), reps=50, warmup=5)
    empty_ms = _cuda_ms(lambda: torch.cuda._sleep(0), reps=50, warmup=5)
    return copy_ms, empty_ms


def _int_ops_ms(ops: float) -> float:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 1e3 * ops / (sms * DISPATCH_LANES_PER_SM * BOOST_CLOCK_HZ)


def _bound(ops: float, nbytes: float) -> tuple[float, str]:
    """Least time the card could take, and what sets it."""
    ops_ms, bytes_ms = _int_ops_ms(ops), 1e3 * nbytes / MEM_BYTES_PER_S
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def sha256_bound_ms(n: int) -> tuple[float, str]:
    return _bound(n * SHA256_OPS_PER_MESSAGE, n * SHA256_BYTES_PER_MESSAGE)


def shuffle_bound_ms(count: int, rounds: int) -> tuple[float, str]:
    row_bytes = 32 * ((count + 255) // 256)
    return _bound(count * rounds * SHUFFLE_OPS_PER_INDEX_ROUND,
                  rounds * (row_bytes + 8) + 8 * count)


def sweeps_bound_ms(n: int) -> tuple[float, str]:
    return _bound(n * SWEEPS_OPS_PER_VALIDATOR, n * SWEEPS_BYTES_PER_VALIDATOR)


def g1_bound_ms(live_per_set: list, keys: int) -> tuple[float, str]:
    """The work this data needs: one mixed addition per live key beyond the
    first of each set (an addition with infinity costs nothing). Changes of
    representation (into and out of Montgomery form) are the kernel's
    choice, not the function's, and are not counted. Bytes: every key read
    once, the offsets, one Jacobian sum written per set."""
    n_sets = len(live_per_set)
    additions = sum(max(live - 1, 0) for live in live_per_set)
    return _bound(additions * G1_MIXED_ADD_MADS, 96 * keys + 8 * (n_sets + 1) + 144 * n_sets)


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
    from ethereum_consensus_tpu_torch.native import bls as native_bls

    # the host libraries build with g++ beside the nvcc builds, so that no
    # timed host path pays for a compiler
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        host = [pool.submit(native.available), pool.submit(native_bls.available)]
        seconds = _kernels.build_all()
        host_ok = [f.result() for f in host]
    native_s = time.perf_counter() - t0
    print(f"build: nvcc {seconds:.3f} s; with the native host libraries {native_s:.3f} s")
    for name in _kernels._LIBRARIES:
        for line in _kernels.build_log(name).splitlines():
            if any(word in line for word in ("entry function", "registers", "spill", "smem")):
                print(f"  ptxas {name}: {line.strip()}")
    if not all(host_ok):
        sys.exit("chip_smoke: the native host libraries need g++")
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


def phase_sha256() -> dict:
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
        print(f"sha256 N={n}: max_abs_err vs plain {err}, hashlib sample ok {sample_ok}")
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
        print(f"sha256 N=2^{log2}: {ms:.4f} ms (bound {bound:.4f} ms by {bound_by})")
    n = 1 << 22
    words = _random_words(n, gen)
    plain_ms = _cuda_ms(lambda: sha256.sha256_64b_plain(words), reps=3, warmup=1)
    print(f"sha256 plain N=2^22: {plain_ms:.3f} ms")
    at_2p22 = timings[-1]
    return {"checks": checks, "timings": timings, "ms": at_2p22["ms"],
            "plain_ms": plain_ms, "bound_ms": at_2p22["bound_ms"],
            "bound_by": at_2p22["bound_by"],
            "max_abs_err": max(c["max_abs_err"] for c in checks)}


def mont_bound_ms(n: int) -> tuple[float, str]:
    """n Montgomery products: one CIOS product's multiply-adds each, and
    two operands read and one result written (48 bytes each)."""
    return _bound(n * FP_MUL_MADS, n * MONT_BYTES)


def _mont_operands(n: int, gen: torch.Generator) -> tuple:
    """n seeded pairs of (n, 12) Montgomery limbs below 2^380 < p on the
    card, with 0, 1, p - 1 and R mod p among the first eight."""
    from ethereum_consensus_tpu_torch.ops import fq

    a, b = (torch.randint(-(2**31), 2**31, (n, 12), dtype=torch.int32, device="cuda",
                          generator=gen) for _ in range(2))
    a[:, 11] &= 0x0FFFFFFF  # below 2^380 < p
    b[:, 11] &= 0x0FFFFFFF
    if n >= 8:
        edges = fq.from_ints([0, 1, fq.P_INT - 1, fq.R % fq.P_INT], "cuda")
        a[:4], b[:4], b[4:8] = edges, edges.flip(0), edges
    return a, b


# The largest (spill stores, stack frame) in bytes that ptxas gives each mxu
# build's functions in the recorded design (PERF.md: pairing_mxu's largest
# spill is fp12_mul_by_line's, its largest frame the Miller kernel's): a
# build that spills or keeps a frame beyond these fails the run.
MXU_PTXAS_CEILINGS = {"mont_mxu": (0, 0), "pairing_mxu": (560, 4232), "g1_sum_mxu": (0, 0)}


def _mxu_ptxas() -> dict:
    """ptxas' registers, frame and spills and the SASS instructions of B8 and
    the mxu builds: each function's largest (spill stores, frame); ``grown``,
    a build whose largest spill or frame exceeds MXU_PTXAS_CEILINGS."""
    out = {}
    for name, ceiling in MXU_PTXAS_CEILINGS.items():
        lines = _ptxas_lines(name, "")
        table: dict = {}
        for line in lines:
            key = line["kernel"].split("_cu_")[-1]
            here = (line.get("spill_stores", 0), line.get("stack_frame", 0))
            table[key] = max(table.get(key, (0, 0)), here)
        most = (max((v[0] for v in table.values()), default=0),
                max((v[1] for v in table.values()), default=0))
        grown = {"largest (spill, frame)": (most, ceiling)} if (
            most[0] > ceiling[0] or most[1] > ceiling[1]) else {}
        sass = _sass_instructions(name)
        print(f"mxu ptxas {name} (spill stores, frame): "
              + "; ".join(f"{k[-48:]} {v}" for k, v in table.items())
              + f"; largest {most} (ceiling {ceiling}); SASS instructions {sass}")
        for line in lines:
            if "registers" in line:
                print(f"  {line['kernel'][-48:]}: {line}")
        out[name] = {"lines": lines, "spills": table, "largest": most, "grown": grown,
                     "sass": sass}
    return out


def phase_mxu() -> dict:
    """B8 alone, its main path: fq8.mont7r over MXU_PAIRS seeded pairs of
    Montgomery values on the card (with 0, 1, p - 1 and R mod p among
    them), bit-exact against fq.mul and against the plain mont7r on the
    card, and against fq.mul at 2^15 and at the tile edges (MXU_TILE_EDGES);
    CUDA-event ms of the kernel at 2^20 and 2^15, of an empty launch, of
    torch._int_mm of the m * p GEMM over all products (the tensor-core part
    alone, not on the path: (2^20 x 64) @ (64 x 120), at the kernel's 112
    columns and at 128), and of the plain version; the ptxas lines and SASS
    instructions of B8 and the mxu builds. A frame or a spill in B8 fails
    the run, and so does an mxu build whose largest spill or frame exceeds
    MXU_PTXAS_CEILINGS."""
    from ethereum_consensus_tpu_torch.ops import fq, fq8

    gen = torch.Generator(device="cuda").manual_seed(8)
    a, b = _mont_operands(MXU_PAIRS, gen)
    _zero_launch_counts()
    got = fq8.mont7r(a, b)
    torch.cuda.synchronize()
    launches = _launch_counts()
    a16, b16 = fq.limbs16(a), fq.limbs16(b)
    errs = {"vs fq.mul": _max_err(got, fq.limbs32(fq.mul(a16, b16))),
            "vs plain": _max_err(got, fq.limbs32(fq8.mont7r_plain(a16, b16)))}
    for n in (MXU_SMALL_PAIRS, *MXU_TILE_EDGES):
        x, y = _mont_operands(n, gen)
        errs[f"n={n} vs fq.mul"] = _max_err(fq8.mont7r(x, y),
                                            fq.limbs32(fq.mul(fq.limbs16(x), fq.limbs16(y))))
    small = _mont_operands(MXU_SMALL_PAIRS, gen)
    timed = {MXU_PAIRS: {"ms": _cuda_ms(lambda: fq8.mont7r_cuda(a, b), reps=10)},
             MXU_SMALL_PAIRS: {"ms": _cuda_ms(lambda: fq8.mont7r_cuda(*small), reps=20)}}
    empty_ms = _cuda_ms(lambda: torch.cuda._sleep(0), reps=50, warmup=5)
    int_mm = {}
    digits = torch.randint(0, 128, (MXU_PAIRS, 64), dtype=torch.int8, device="cuda", generator=gen)
    for columns in MXU_YARDSTICK_COLUMNS:
        toeplitz = torch.randint(0, 128, (columns, 64), dtype=torch.int8, device="cuda",
                                 generator=gen).t()  # (64, columns), column-major
        try:
            int_mm[columns] = _cuda_ms(lambda: torch._int_mm(digits, toeplitz), reps=20)
        except RuntimeError as e:  # a yardstick, not on the path
            print(f"mxu: torch._int_mm at {columns} columns not measured: {e}")
            int_mm[columns] = None
    plain_ms = _cuda_ms(lambda: fq8.mont7r_plain(a16, b16), reps=3, warmup=1)
    bound, bound_by = mont_bound_ms(MXU_PAIRS)
    small_bound, _ = mont_bound_ms(MXU_SMALL_PAIRS)
    ms = timed[MXU_PAIRS]["ms"]
    print(f"mxu: {MXU_PAIRS} products: max_abs_err {errs}; {ms:.4f} ms (bound {bound:.4f} ms by "
          f"{bound_by}); plain {plain_ms:.3f} ms; launches {launches['mont_mxu']}")
    print(f"mxu: B8 at {MXU_SMALL_PAIRS} products {timed[MXU_SMALL_PAIRS]['ms']:.4f} ms")
    print(f"mxu: bound at {MXU_SMALL_PAIRS} {small_bound:.4f} ms; empty launch {empty_ms:.4f} ms; "
          f"torch._int_mm of the m p GEMM over {MXU_PAIRS} products by columns {int_mm} ms")
    ptxas = _mxu_ptxas()
    if any(errs.values()) or launches["mont_mxu"] != 1:
        sys.exit(f"chip_smoke: the mxu product disagrees or did not launch: {errs}, {launches}")
    b8 = ptxas["mont_mxu"]["lines"]
    if any(line.get("spill_stores") or line.get("stack_frame") for line in b8):
        sys.exit(f"chip_smoke: ptxas gives B8 a frame or spills: {b8}")
    grown = {name: v["grown"] for name, v in ptxas.items() if v["grown"]}
    if grown:
        sys.exit(f"chip_smoke: an mxu build spills or keeps a frame beyond its ceiling: {grown}")
    return {"pairs": MXU_PAIRS, "checks": errs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "max_abs_err": max(errs.values()),
            "launches": launches, "timed": timed, "small_bound_ms": small_bound,
            "empty_ms": empty_ms, "int_mm_ms": int_mm,
            "ptxas": {k: {"spills": v["spills"], "largest": v["largest"], "sass": v["sass"]}
                      for k, v in ptxas.items()}}


def _synthetic_pubkey(index: int) -> bytes:
    """48 bytes that never decompress as a BLS key (leading 0xff)."""
    return (b"\xff" + hashlib.sha256(b"synthetic-pk" + index.to_bytes(8, "little")).digest()[:15]
            + index.to_bytes(32, "big"))


def build_registry_state(validators: int, ctx=None, public_key=_synthetic_pubkey):
    """A phase0 state of ``validators`` active validators on ``ctx``'s
    preset (mainnet by default), built directly (no deposits): the registry
    every slot hashes. ``public_key(i)`` gives validator i's key."""
    from ethereum_consensus_tpu_torch.config import Context
    from ethereum_consensus_tpu_torch.models.phase0 import build
    from ethereum_consensus_tpu_torch.primitives import FAR_FUTURE_EPOCH, GENESIS_EPOCH

    ctx = ctx or Context.for_mainnet()
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
            public_key=public_key(i),
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


def phase_registry(validators: int) -> dict:
    """The state both the slice and the block phase start from: slot 0's
    committees and the slot-BLOCK_SLOT proposer hold real keys
    SecretKey(i + 1), every other validator a synthetic key (the pattern of
    tests/chain_utils.py:1166-1229). Committees and proposer depend on the
    seed and balances only, so they are planned before the keys change."""
    from ethereum_consensus_tpu_torch import ops
    from ethereum_consensus_tpu_torch.domains import DomainType
    from ethereum_consensus_tpu_torch.models.phase0 import helpers as h

    t0 = time.perf_counter()
    with _collector_paused():
        state, ctx = build_registry_state(validators)
    build_s = time.perf_counter() - t0
    ops.uninstall()
    t0 = time.perf_counter()
    per_slot = h.get_committee_count_per_slot(state, 0, ctx)
    committees = [h.get_beacon_committee(state, 0, index, ctx) for index in range(per_slot)]
    proposer_seed = hashlib.sha256(
        h.get_seed(state, 0, DomainType.BEACON_PROPOSER, ctx)
        + BLOCK_SLOT.to_bytes(8, "little")
    ).digest()
    proposer = h.compute_proposer_index(
        state, h.get_active_validator_indices(state, 0), proposer_seed, ctx
    )
    attester_seed = h.get_seed(state, 0, DomainType.BEACON_ATTESTER, ctx)
    ops.uninstall()  # drop the host shuffle from the cache
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i, key in _public_keys({proposer, *(i for c in committees for i in c)}).items():
        state.validators[i].public_key = key
    keys_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = type(state).serialize(state)
    serialize_s = time.perf_counter() - t0
    print(f"registry: {validators} validators, {len(data)} state bytes; build {build_s:.1f} s, "
          f"committees {plan_s:.1f} s ({per_slot} of {len(committees[0])}), "
          f"{sum(map(len, committees)) + 1} real keys {keys_s:.1f} s, "
          f"serialize {serialize_s:.1f} s; proposer {proposer}")
    return {"data": data, "ctx": ctx, "committees": committees, "proposer": proposer,
            "state": state,
            "attester_seed": attester_seed, "state_bytes": len(data), "build_s": build_s,
            "committees_s": plan_s, "keys_s": keys_s, "serialize_s": serialize_s}


def _setup_state(registry: dict):
    """A copy of the registry's state for untimed set-up work (the block's
    scratch run, the epoch, altair and window set-ups): a copy costs less
    than a read. A timed path reads its state from SSZ instead: a copy
    carries the registry's wiring, so its first root would skip the walk
    that a state just read pays."""
    with _collector_paused():
        return registry["state"].copy()


def _ptxas_lines(library: str, name: str, log: "str | None" = None) -> list:
    """ptxas' registers, frame, spills and shared memory of every kernel of
    a library whose (mangled) name holds ``name``: each template
    instantiation on its own line. From ``log`` when given, else from the
    library's build."""
    import re

    from ethereum_consensus_tpu_torch import _kernels

    out, current = [], None
    for line in (_kernels.build_log(library) if log is None else log).splitlines():
        match = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if match:
            current = match.group(1) if name in match.group(1) else None
            continue
        if current:
            for key, pattern in (("stack_frame", r"(\d+) bytes stack frame"),
                                 ("spill_stores", r"(\d+) bytes spill stores"),
                                 ("registers", r"Used (\d+) registers"),
                                 ("smem", r"(\d+) bytes smem")):
                found = re.search(pattern, line)
                if found:
                    if not out or out[-1]["kernel"] != current:
                        out.append({"kernel": current})
                    out[-1][key] = int(found.group(1))
    return out


def phase_shuffle(seed: bytes) -> dict:
    from ethereum_consensus_tpu_torch.config import Context
    from ethereum_consensus_tpu_torch.models.phase0 import helpers as h
    from ethereum_consensus_tpu_torch.ops import shuffle

    ctx = Context.for_mainnet()
    assert ctx.SHUFFLE_ROUND_COUNT == SHUFFLE_ROUNDS
    rng = np.random.default_rng(90)
    checks, timings, main = [], [], None
    for count in (*SHUFFLE_CHECK_COUNTS, SHUFFLE_WIDE_COUNT):
        pivots, sources = (
            torch.from_numpy(t).cuda() for t in shuffle.shuffle_sources(count, seed, SHUFFLE_ROUNDS)
        )
        got = shuffle.shuffle(pivots, sources, count)
        torch.cuda.synchronize()
        plain = shuffle.shuffle_plain(pivots, sources, count)
        err = int((got - plain).abs().max().item())
        sample = sorted({0, count - 1, *rng.integers(0, count, 24).tolist()})
        got_host = got.cpu().numpy()
        spec_ok = all(
            got_host[i] == h.compute_shuffled_index(i, count, seed, ctx) for i in sample
        )
        line = f"shuffle count={count}: max_abs_err vs plain {err}, spec sample ok {spec_ok}"
        if count >= 1 << 15:
            # the launch alone: the wrapper's pivot check waits for the card
            ms = _cuda_ms(lambda: shuffle._launch(pivots, sources, count), reps=20)
            bound, bound_by = shuffle_bound_ms(count, SHUFFLE_ROUNDS)
            timings.append({"count": count, "ms": ms, "bound_ms": bound, "bound_by": bound_by})
            line += f"; {ms:.4f} ms (bound {bound:.4f} ms by {bound_by})"
        print(line)
        if err != 0 or not spec_ok:
            sys.exit(f"chip_smoke: shuffle kernel disagrees at count={count}")
        checks.append({"count": count, "max_abs_err": err})
        if count == SHUFFLE_MAIN_COUNT:
            main = (pivots, sources)
    plain_ms = _cuda_ms(lambda: shuffle.shuffle_plain(*main, SHUFFLE_MAIN_COUNT), reps=3,
                        warmup=1)
    print(f"shuffle plain count={SHUFFLE_MAIN_COUNT}: {plain_ms:.3f} ms")
    ptxas = _ptxas_lines("shuffle", "shuffle_kernel")
    print(f"shuffle ptxas: {ptxas}; SASS instructions {_sass_instructions('shuffle')}")
    at_main = next(t for t in timings if t["count"] == SHUFFLE_MAIN_COUNT)
    return {"checks": checks, "timings": timings, "ms": at_main["ms"], "plain_ms": plain_ms,
            "bound_ms": at_main["bound_ms"], "bound_by": at_main["bound_by"],
            "max_abs_err": max(c["max_abs_err"] for c in checks), "ptxas": ptxas}


def _neg_raw(raw: bytes) -> bytes:
    from ethereum_consensus_tpu_torch.ops.g1 import P_INT

    y = int.from_bytes(raw[48:], "big")
    return raw[:48] + ((P_INT - y) % P_INT).to_bytes(48, "big")


def _raw_keys(indices: list) -> list:
    from ethereum_consensus_tpu_torch.native import bls as native_bls

    keys = _public_keys(indices)
    out = native_bls.g1_decompress_batch([keys[i] for i in indices], check_subgroup=False)
    if any(rc != 0 for rc, _raw, _inf in out):
        sys.exit("chip_smoke: a real key did not decompress")
    return [raw for _rc, raw, _inf in out]


def phase_g1(committees: list, proposer: int) -> dict:
    """The block's sets in the order its signature batch has them: the
    proposer twice (block signature, randao reveal), then the 64
    committees."""
    from ethereum_consensus_tpu_torch.native import bls as native_bls
    from ethereum_consensus_tpu_torch.ops import g1

    raws = _raw_keys([i for c in committees for i in c] + [proposer])
    attesters, proposer_raw = raws[:-1], raws[-1]
    block_sets, at = [], 0
    for c in committees:
        block_sets.append(attesters[at : at + len(c)])
        at += len(c)
    block_sets = [[proposer_raw], [proposer_raw], *block_sets]
    k, inf = attesters, b"\x00" * 96
    edge_sets = [k[:1], k[1:4], k[4:12], [k[12], inf, k[13]], [k[14], k[14]],
                 [k[15], k[16], k[15]], [k[17], _neg_raw(k[17])], [inf, inf, inf], [],
                 k[:200], k[:129]]
    shapes = [("edge", edge_sets), ("one set of 2^15", [attesters[: 1 << 15]]),
              ("block", block_sets)]
    checks, outputs = {}, {}
    for name, sets in shapes:
        points, offsets = g1.sets_to_csr(sets)
        points_d, offsets_d = points.cuda(), offsets.cuda()
        got = g1.g1_sum_sets(points_d, offsets_d)
        outputs[name] = (points_d, offsets_d, got)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = g1.g1_sum_sets_plain(points_d, offsets_d)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = int((got.to(torch.int64) - plain.to(torch.int64)).abs().max().item())
        affine = g1.jacobian_to_affine(got)
        native_ok = True
        # the first sets of each shape hold distinct real keys only
        for (raw, is_inf), s in list(zip(affine, sets))[:3]:
            rc, agg = native_bls.aggregate_public_keys([native_bls.g1_compress_raw(r) for r in s])
            native_ok &= rc == 0 and not is_inf and native_bls.g1_compress_raw(raw) == agg
        sizes = [len(s) for s in sets]
        live = [sum(1 for r in s if any(r)) for s in sets]
        # the launch alone: the wrapper's offsets check waits for the card
        ms = _cuda_ms(lambda: g1._launch(points_d, offsets_d, len(sets)), reps=10)
        bound, bound_by = g1_bound_ms(live, sum(sizes))
        print(f"g1 {name}: {len(sets)} sets, {sum(sizes)} keys: max_abs_err vs plain {err}, "
              f"native sample ok {native_ok}; {ms:.4f} ms (bound {bound:.4f} ms by "
              f"{bound_by}); plain {plain_s:.3f} s")
        if err != 0 or not native_ok:
            sys.exit(f"chip_smoke: G1 set-sum kernel disagrees on the {name} sets")
        checks[name] = {"sets": len(sets), "keys": sum(sizes), "max_abs_err": err, "ms": ms,
                        "bound_ms": bound, "bound_by": bound_by, "plain_once_s": plain_s}
    plain_ms = _cuda_ms(lambda: g1.g1_sum_sets_plain(points_d, offsets_d), reps=3, warmup=1)
    print(f"g1 plain, block shape: {plain_ms:.3f} ms")
    ptxas = _ptxas_lines("g1_sum", "g1_sum_chains_kernel") + _ptxas_lines("g1_sum",
                                                                          "g1_sum_fold_kernel")
    print(f"g1 ptxas: {ptxas}; SASS instructions {_sass_instructions('g1_sum')}")
    main = checks["block"]
    return {"checks": checks, "ms": main["ms"], "plain_ms": plain_ms,
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
            "mxu": _g1_mxu(outputs, main), "ptxas": ptxas}


def _g1_mxu(outputs: dict, main: dict) -> dict:
    """B6's mxu build (EC_PAIRING_MULT=mxu): against the u64 kernel on the
    block's sets, against the plain version under mxu on the edge sets,
    limb for limb; CUDA-event ms at the block's shape."""
    from ethereum_consensus_tpu_torch.ops import fq8, g1

    fq8.set_multiplier("mxu")
    try:
        errs = {}
        for name in ("edge", "block"):
            points_d, offsets_d, u64 = outputs[name]
            got = g1.g1_sum_sets(points_d, offsets_d)
            torch.cuda.synchronize()
            errs[f"{name} vs u64"] = _max_err(got, u64)
        points_d, offsets_d, _ = outputs["edge"]
        errs["edge vs plain"] = _max_err(g1.g1_sum_sets(points_d, offsets_d),
                                         g1.g1_sum_sets_plain(points_d, offsets_d))
        points_d, offsets_d, _ = outputs["block"]
        sets = offsets_d.shape[0] - 1
        ms = _cuda_ms(lambda: g1._launch(points_d, offsets_d, sets), reps=10)
        plain_ms = _cuda_ms(lambda: g1.g1_sum_sets_plain(points_d, offsets_d), reps=3, warmup=1)
    finally:
        fq8.set_multiplier("u64")
    print(f"g1 mxu build: max_abs_err {errs}; {ms:.4f} ms at the block's {sets} sets (u64 "
          f"{main['ms']:.4f}; bound {main['bound_ms']:.4f} ms by {main['bound_by']}); plain "
          f"under mxu {plain_ms:.3f} ms; kernel SASS instructions "
          f"{_sass_instructions('g1_sum_mxu')}")
    if any(errs.values()):
        sys.exit(f"chip_smoke: the mxu G1 set-sum kernel disagrees: {errs}")
    return {"checks": errs, "ms": ms, "plain_ms": plain_ms, "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "max_abs_err": max(errs.values())}


# (leaves, limit, start_level) of the htr phase's B2 checks: the registry
# width with and without the registry limit, an odd width just below it, one
# and three leaves, an odd width past a launch's blocks, and leaves three
# levels above the chunk layer (the sharded merkleizer's top tree)
MERKLE_CHECK_SHAPES = ((1 << 20, None, 0), (1 << 20, 2**40, 0), ((1 << 20) - 3, None, 0),
                       (1, None, 0), (3, None, 0), ((1 << 17) + 1, None, 0),
                       (1 << 17, 2**37, 3), (1 << 15, 2**40, 0))
# grid launches of one B2 call up to 2^22 nodes: the blocks, then the tail's
# one block (one launch alone up to 2^8 nodes)
MERKLE_MAX_LAUNCHES = 2
# (log2 leaves, depth) of the timed B2 calls: the registry at its limit, and
# the mesh route's threshold (parallel/runtime.py DEFAULT_MERKLE_MIN_CHUNKS)
MERKLE_TIMED = ((20, 40), (15, 40))


def _b1_chain_root(words: torch.Tensor, zero_words: torch.Tensor, depth: int) -> torch.Tensor:
    """The device merkleizer before B2: one B1 launch a level, the
    concatenations between them, one more launch a zero-sibling level."""
    from ethereum_consensus_tpu_torch.ops import sha256

    nodes, n, level = words, words.shape[1], 0
    while n > 1:
        if n % 2 == 1:
            nodes = torch.cat([nodes, zero_words[level][:, None]], dim=1)
            n += 1
        pairs = nodes.reshape(8, n // 2, 2)
        nodes = sha256.sha256_64b(torch.cat([pairs[:, :, 0], pairs[:, :, 1]], dim=0))
        n //= 2
        level += 1
    for d in range(level, depth):
        nodes = sha256.sha256_64b(torch.cat([nodes, zero_words[d][:, None]], dim=0))
    return nodes[:, 0]


def merkle_bound_ms(leaves: int, depth: int) -> tuple[float, str]:
    """B2's least work: the tree's messages (every parent of the populated
    tree, then one a zero-sibling level) at B1's operations a message; each
    leaf read once, the root written once."""
    messages = leaves - 1 + depth - (leaves - 1).bit_length()
    return _bound(messages * SHA256_OPS_PER_MESSAGE, 32 * leaves + 32)


def _sm_clock_hz() -> float:
    """The SM clock NVML reads now."""
    return 1e6 * float(_clocks().split()[0])


def merkle_message_cycles() -> float:
    """One thread's clock64 cycles a dependent message, the median of five
    runs of 40 levels of the zero chain (merkle_latency_launch: the tail's
    code path on one thread)."""
    from ethereum_consensus_tpu_torch import _kernels
    from ethereum_consensus_tpu_torch.ops import merkle

    lib = _kernels.load("merkle")
    zero = merkle.zero_hash_words("cuda")
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    root = torch.empty(8, dtype=torch.int32, device="cuda")
    readings = []
    for _ in range(5):
        rc = lib.merkle_latency_launch(zero.data_ptr(), 40, cycles.data_ptr(), root.data_ptr(),
                                       torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            sys.exit(f"chip_smoke: the merkle latency launch failed: CUDA error {rc}")
        torch.cuda.synchronize()
        readings.append(int(cycles.item()))
    if not torch.equal(root, zero[40]):
        sys.exit("chip_smoke: the merkle latency chain does not end at the zero word of level 40")
    return statistics.median(readings) / 40


def phase_htr(log2_leaves: int) -> dict:
    """B2 (csrc/merkle.cu) against its plain version on the card and the
    host merkleizer, bit-exact, on MERKLE_CHECK_SHAPES (the plain version
    timed on its one call at 2^20 leaves and limit 2^40); its CUDA-event
    times at MERKLE_TIMED beside their bounds and latency floors, and at
    2^20 leaves and limit 2^40 beside the per-level B1 chain it replaces;
    then ops.merkleize_chunks_device on 2^20 random chunks against the host
    merkleizer, its wall split into byte conversion, upload, kernels and the
    root's way back."""
    from ethereum_consensus_tpu_torch import convert, ops
    from ethereum_consensus_tpu_torch.ops import merkle, sha256
    from ethereum_consensus_tpu_torch.ssz.merkle import merkleize_chunks, next_pow_of_two

    ops.uninstall()
    zero = merkle.zero_hash_words("cuda")
    rng = np.random.default_rng(42)
    err, launches_at, plain_ms = 0, {}, None
    for leaves, limit, start in MERKLE_CHECK_SHAPES:
        chunks = rng.bytes(32 * leaves)
        width = next_pow_of_two(leaves if limit is None else limit)
        depth = (width - 1).bit_length() + start
        words = convert.words_from_chunks(chunks, "cuda")
        merkle.launch_count = 0
        got = merkle.reduce_levels(words, zero, depth, start)
        torch.cuda.synchronize()
        launches = merkle.launch_count
        if (leaves, limit, start) == (1 << log2_leaves, 2**40, 0):
            # the plain version's time, once: its repeats cost seconds each
            plain, plain_ms = _timed_once(
                lambda: merkle.reduce_levels_plain(words, zero, depth, start))
        else:
            plain = merkle.reduce_levels_plain(words, zero, depth, start)
        host = merkleize_chunks(chunks, limit if start == 0 else width, level_offset=start)
        step = int((got.to(torch.int64) - plain.to(torch.int64)).abs().max().item())
        host_ok = convert.chunks_from_words(got[:, None]) == host
        print(f"htr B2 {leaves} leaves, limit {limit}, start_level {start}: max_abs_err vs "
              f"plain {step}, host root equal {host_ok}, {launches} launches")
        if step or not host_ok:
            sys.exit(f"chip_smoke: B2 disagrees at {leaves} leaves, limit {limit}, "
                     f"start_level {start}")
        err = max(err, step)
        launches_at[f"{leaves}-{limit}-{start}"] = launches
    if any(not 0 < count <= MERKLE_MAX_LAUNCHES for count in launches_at.values()):
        sys.exit(f"chip_smoke: B2's launches are off: {launches_at}")

    # the latency floor: every level waits for the one below, so a tree of
    # depth d takes at least d dependent messages on one thread
    message_cycles = merkle_message_cycles()
    clock_hz = _sm_clock_hz()
    print(f"htr B2 latency: one thread's dependent message {message_cycles:.1f} clock64 cycles "
          f"at {clock_hz / 1e6:.0f} MHz, {1e6 * message_cycles / clock_hz:.4f} us")
    timed = {}
    for log2, depth in MERKLE_TIMED:
        leaves = 1 << log2
        words = convert.words_from_chunks(rng.bytes(32 * leaves), "cuda")
        ms = _cuda_ms(lambda: merkle.reduce_levels_cuda(words, zero, depth), reps=20)
        bound, bound_by = merkle_bound_ms(leaves, depth)
        floor = 1e3 * depth * message_cycles / clock_hz
        timed[log2] = {"ms": ms, "bound_ms": bound, "bound_by": bound_by,
                       "latency_floor_ms": floor}
        print(f"htr B2 2^{log2} leaves at limit 2^{depth}: {ms:.4f} ms (bound {bound:.4f} ms by "
              f"{bound_by}; latency floor {floor:.4f} ms: {depth} dependent messages)")
    n = 1 << log2_leaves
    chunks = rng.bytes(32 * n)
    words = convert.words_from_chunks(chunks, "cuda")
    ms, bound, bound_by = (timed[log2_leaves][k] for k in ("ms", "bound_ms", "bound_by"))
    b1_ms = _cuda_ms(lambda: _b1_chain_root(words, zero, 40), reps=10)
    ptxas = _ptxas_lines("merkle", "merkle_tree_kernel")
    print(f"htr B2 2^{log2_leaves} leaves at limit 2^40: the per-level B1 chain it replaces "
          f"{b1_ms:.4f} ms; plain {plain_ms:.3f} ms; SASS instructions "
          f"{_sass_instructions('merkle')}; ptxas {ptxas}")
    if any(line.get("spill_stores") or line.get("stack_frame") for line in ptxas):
        print("htr B2: ptxas gives the kernel a frame or spills")

    merkle.launch_count = sha256.launch_count = 0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        device_root = ops.merkleize_chunks_device(chunks, device="cuda")
        times.append(time.perf_counter() - t0)
    launch_counts = {"merkle_levels": merkle.launch_count // 3,
                     "sha256_64b": sha256.launch_count // 3}
    # the same call's steps apart, each ended on a synchronize
    splits = []
    for _ in range(3):
        t0 = time.perf_counter()
        host_words = convert.words_from_chunks(chunks, "cpu")
        t1 = time.perf_counter()
        dev = host_words.to("cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        root = merkle.merkle_root_words(dev, zero, n.bit_length() - 1)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        split_root = convert.chunks_from_words(root[:, None])
        t4 = time.perf_counter()
        splits.append({"bytes_to_words": t1 - t0, "upload": t2 - t1, "kernels": t3 - t2,
                       "root_back": t4 - t3})
    split = {k: statistics.median(sp[k] for sp in splits) for k in splits[0]}
    t0 = time.perf_counter()
    host_root = merkleize_chunks(chunks)
    host_s = time.perf_counter() - t0
    print(f"htr 2^{log2_leaves} leaves: device {statistics.median(times):.4f} s "
          f"(first {times[0]:.4f} s, launches {launch_counts}), host {host_s:.4f} s, "
          f"roots equal {device_root == host_root == split_root}; the device call's wall "
          f"split {_rounded(split, 5)} s")
    if device_root != host_root or split_root != host_root:
        sys.exit("chip_smoke: device merkle root disagrees with the host root")
    if launch_counts["merkle_levels"] == 0:
        sys.exit(f"chip_smoke: the device merkleizer's launches are off: {launch_counts}")
    return {"leaves": n, "device_s": statistics.median(times), "device_first_s": times[0],
            "host_s": host_s, "launches": launch_counts["merkle_levels"],
            "launch_counts": launch_counts, "wall_split_s": split,
            "launches_by_shape": launches_at, "ms": ms, "b1_chain_ms": b1_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err,
            "timed": timed, "message_cycles": message_cycles, "ptxas": ptxas}


def phase_slice(data: bytes, ctx, slots: int) -> dict:
    from ethereum_consensus_tpu_torch import convert, ops
    from ethereum_consensus_tpu_torch.models.phase0 import slot_processing
    from ethereum_consensus_tpu_torch.ops import sha256
    from ethereum_consensus_tpu_torch.ssz import hash as ssz_hash

    t0 = time.perf_counter()
    with _collector_paused():  # untimed set-up: three 2^20 reads
        device_state = convert.state_from_ssz(data, ctx.preset)
        host_state = convert.state_from_ssz(data, ctx.preset)
        timed_state = convert.state_from_ssz(data, ctx.preset)
    state_type = type(device_state)
    setup_s = time.perf_counter() - t0
    print(f"slice: {len(device_state.validators)} validators, three reads of "
          f"{len(data)} bytes {setup_s:.1f} s")

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
    timed_state.validators[len(timed_state.validators) // 2].effective_balance = 31 * 10**9
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
    return {"validators": len(device_state.validators), "setup_s": setup_s,
            "slots": slots, "device_slots_s": device_slots_s, "host_slots_s": host_slots_s,
            "launches": launches, "cold_root_s": cold_s, "cold_root_launches": cold_launches,
            "cold_root_digests": cold_digests, "cold_root_routed": cold_routed,
            "cold_root_routed_s": routed_s, "warm_root_s": warm_s,
            "one_validator_edit_s": edit_s}


def make_block(scratch, ctx, committees: list, proposer: int, crossed: "list | None" = None):
    """A signed block at BLOCK_SLOT carrying one aggregate attestation per
    slot-0 committee (full participation). A committee's aggregate
    signature is one signature under the secret key sum(i + 1) mod r: the
    same point, so the same bytes, as aggregating its members'
    signatures. The state root comes from a host run on a scratch copy,
    which also verifies every signature inline. Returns the block and a copy
    whose attestation TAMPERED_ATTESTATION carries the next one's signature."""
    from ethereum_consensus_tpu_torch.crypto import bls
    from ethereum_consensus_tpu_torch.crypto.fields import R
    from ethereum_consensus_tpu_torch.domains import DomainType
    from ethereum_consensus_tpu_torch.models.phase0 import block_processing, build
    from ethereum_consensus_tpu_torch.models.phase0 import helpers as h
    from ethereum_consensus_tpu_torch.models.phase0 import slot_processing
    from ethereum_consensus_tpu_torch.models.phase0.containers import BeaconBlockHeader
    from ethereum_consensus_tpu_torch.signing import compute_signing_root
    from ethereum_consensus_tpu_torch.ssz import uint64

    ns = build(ctx.preset)
    slot_processing.process_slots(scratch, BLOCK_SLOT, ctx)
    if crossed is not None:
        crossed.append(scratch.copy())
    if h.get_beacon_proposer_index(scratch, ctx) != proposer:
        sys.exit("chip_smoke: the planned proposer is not the state's proposer")
    root_at_0 = h.get_block_root_at_slot(scratch, 0)
    attester_domain = h.get_domain(scratch, DomainType.BEACON_ATTESTER, 0, ctx)
    attestations = []
    for index, committee in enumerate(committees):
        att_data = ns.AttestationData(
            slot=0, index=index, beacon_block_root=root_at_0,
            source=scratch.current_justified_checkpoint.copy(),
            target=ns.Checkpoint(epoch=0, root=root_at_0),
        )
        root = compute_signing_root(ns.AttestationData, att_data, attester_domain)
        summed = bls.SecretKey(sum(i + 1 for i in committee) % R)
        attestations.append(ns.Attestation(
            aggregation_bits=[True] * len(committee), data=att_data,
            signature=summed.sign(root).to_bytes(),
        ))
    proposer_key = bls.SecretKey(proposer + 1)
    randao_root = compute_signing_root(
        uint64, 0, h.get_domain(scratch, DomainType.RANDAO, 0, ctx)
    )
    block = ns.BeaconBlock(
        slot=BLOCK_SLOT, proposer_index=proposer,
        parent_root=BeaconBlockHeader.hash_tree_root(scratch.latest_block_header),
        body=ns.BeaconBlockBody(
            randao_reveal=proposer_key.sign(randao_root).to_bytes(),
            eth1_data=scratch.eth1_data.copy(), attestations=attestations,
        ),
    )
    block_processing.process_block(scratch, block, ctx)
    block.state_root = type(scratch).hash_tree_root(scratch)
    proposer_domain = h.get_domain(scratch, DomainType.BEACON_PROPOSER, None, ctx)

    def signed(message):
        root = compute_signing_root(ns.BeaconBlock, message, proposer_domain)
        return ns.SignedBeaconBlock(message=message,
                                    signature=proposer_key.sign(root).to_bytes())

    tampered = block.copy()
    atts = tampered.body.attestations
    atts[TAMPERED_ATTESTATION].signature = atts[TAMPERED_ATTESTATION + 1].signature
    return signed(block), signed(tampered)


_MISSING = object()


@contextlib.contextmanager
def _patched(owner, name, wrap):
    """``owner.name`` (a module's or a class's attribute) wrapped while the
    block runs; afterwards the owner's own entry is put back, or removed
    where a class inherited the attribute (so a classmethod stays one)."""
    own = vars(owner).get(name, _MISSING)
    setattr(owner, name, wrap(getattr(owner, name)))
    try:
        yield
    finally:
        if own is _MISSING:
            delattr(owner, name)
        else:
            setattr(owner, name, own)


@contextlib.contextmanager
def _collector_paused():
    """Automatic garbage collection off for untimed host work: with several
    2^20-validator states on the heap, the full collections that a state's
    reads, copies and upgrades trigger take about as long as the work
    itself. Timed paths run with the collector as it was."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _host_timer(bucket: dict, key: str):
    def wrap(fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                bucket[key] = bucket.get(key, 0.0) + time.perf_counter() - t0
        return timed
    return wrap


def _event_timer(events: list, name: str):
    """CUDA events around each launch of a kernel wrapper."""
    def wrap(fn):
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            events.append((name, start, end))
            return out
        return timed
    return wrap


def _apply(state, signed_block, ctx, kernel_events: list | None = None) -> tuple[float, dict]:
    """Cold Executor.apply_block; returns (seconds, host breakdown)."""
    from ethereum_consensus_tpu_torch.crypto import bls
    from ethereum_consensus_tpu_torch.executor import Executor
    from ethereum_consensus_tpu_torch.models.phase0 import helpers as h
    from ethereum_consensus_tpu_torch.models.phase0 import state_transition
    from ethereum_consensus_tpu_torch.ops import g1, sha256, shuffle

    parts: dict = {}
    with contextlib.ExitStack() as stack:
        for module, name, key in (
            (state_transition, "process_slots", "process_slots"),
            (state_transition, "process_block", "process_block"),
            (h, "_compute_shuffled_pair", "shuffle"),
            (bls, "verify_signature_sets", "signature_batch"),
        ):
            stack.enter_context(_patched(module, name, _host_timer(parts, key)))
        if kernel_events is not None:
            for module, name, key in ((sha256, "sha256_64b_cuda", "sha256_64b"),
                                      (shuffle, "_launch", "shuffle"),
                                      (g1, "_launch", "g1_sum_sets")):
                stack.enter_context(_patched(module, name, _event_timer(kernel_events, key)))
        executor = Executor(state, ctx)
        # The heap holds several 2^20-validator states; a full collection
        # that lands inside one path's apply costs seconds. Freezing what
        # exists keeps the collector to the apply's own objects on both paths;
        # the full collection first sets the collector's count of long-lived
        # objects to the heap's, so the apply's own allocations seldom start
        # another full pass.
        gc.collect()
        gc.freeze()
        try:
            t0 = time.perf_counter()
            executor.apply_block(signed_block)
            if kernel_events is not None:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            gc.unfreeze()
    return seconds, parts


def _rejection_in_slot(state, signed_block, ctx, fork) -> str:
    """The error a block at ``state``'s own slot (a state already processed
    to it) raises, or "accepted": the fork's in-slot transition, as
    Executor runs it for a block on its upgrade slot."""
    transition = fork.state_transition
    try:
        transition.state_transition_block_in_slot(state, signed_block,
                                                  transition.Validation.ENABLED, ctx)
    except Exception as exc:  # noqa: BLE001 — the error is the result
        return f"{type(exc).__name__}: {exc}"
    return "accepted"


def phase_block(registry: dict) -> dict:
    """The slice's main path: one signed block through Executor.apply_block,
    cold, on the host path and with the kernels installed."""
    from ethereum_consensus_tpu_torch import convert, ops
    from ethereum_consensus_tpu_torch.models import phase0
    from ethereum_consensus_tpu_torch.ops import g1, sha256, shuffle

    data, ctx = registry["data"], registry["ctx"]
    with _collector_paused():
        t0 = time.perf_counter()
        crossed: list = []
        good, tampered = make_block(_setup_state(registry), ctx, registry["committees"],
                                    registry["proposer"], crossed)
        host_reject_state = crossed.pop()
        make_s = time.perf_counter() - t0
        n_keys = sum(len(a.aggregation_bits) for a in good.message.body.attestations) + 2
        t0 = time.perf_counter()
        host_state = convert.state_from_ssz(data, ctx.preset)
        device_state = convert.state_from_ssz(data, ctx.preset)
        read_s = time.perf_counter() - t0
    print(f"block: slot {BLOCK_SLOT}, {len(good.message.body.attestations)} attestations, "
          f"{n_keys} keys in the signature batch; made in {make_s:.1f} s; "
          f"pre-states read in {read_s:.1f} s")

    ops.uninstall()
    host_s, host_parts = _apply(host_state, good, ctx)

    ops.uninstall()  # clears the shuffle cache: the device run shuffles anew
    ops.install(device="cuda")
    events: list = []
    sha256.launch_count = shuffle.launch_count = g1.launch_count = 0
    device_s, device_parts = _apply(device_state, good, ctx, events)
    launches = {"sha256_64b": sha256.launch_count, "shuffle": shuffle.launch_count,
                "g1_sum_sets": g1.launch_count}
    ops.uninstall()
    kernel_ms: dict = {}
    for name, start, end in events:
        kernel_ms[name] = kernel_ms.get(name, 0.0) + start.elapsed_time(end)

    state_type = type(host_state)
    same_bytes = state_type.serialize(host_state) == state_type.serialize(device_state)
    root = state_type.hash_tree_root(device_state)
    same_root = root == state_type.hash_tree_root(host_state)
    print(f"block: cold apply host {host_s:.3f} s {_rounded(host_parts)}")
    print(f"block: cold apply device {device_s:.3f} s {_rounded(device_parts)}; "
          f"launches {launches}; kernel ms inside {_rounded(kernel_ms, 4)}")
    print(f"block: bytes equal {same_bytes}, roots equal {same_root}, "
          f"post-state root {root.hex()}")
    if not (same_bytes and same_root):
        sys.exit("chip_smoke: the block's post-state differs between host and device")
    if not all(launches.values()):
        sys.exit(f"chip_smoke: a kernel of the block path was never launched: {launches}")

    # the tampered block on the crossing the good block was built on (the
    # same bytes as the pre-state's crossing to the block's slot), a copy of
    # it for each path
    with _collector_paused():
        device_reject_state = host_reject_state.copy()
    host_error = _rejection_in_slot(host_reject_state, tampered, ctx, phase0)
    ops.install(device="cuda")
    device_error = _rejection_in_slot(device_reject_state, tampered, ctx, phase0)
    ops.uninstall()
    print(f"block: attestation {TAMPERED_ATTESTATION} with the signature of "
          f"{TAMPERED_ATTESTATION + 1}: "
          f"host {host_error!r}, device {device_error!r}")
    if host_error != device_error or not host_error.startswith("InvalidAttestation"):
        sys.exit("chip_smoke: the tampered block was not rejected alike on both paths")
    return {"attestations": len(good.message.body.attestations), "keys": n_keys,
            "signed_block": good,
            "make_s": make_s, "read_s": read_s, "host_apply_s": host_s,
            "host_parts_s": host_parts, "device_apply_s": device_s,
            "device_parts_s": device_parts, "launches": launches,
            "kernel_ms_inside": kernel_ms, "rejection": device_error}


# --- telemetry: the staged epoch kernels and a recorded block --------------

# The staged programs' sizes: the main path's registry, and an unaligned one
# (the pairs' rows then lie off 16 bytes: one validator a thread).
STAGED_SIZES = (VALIDATORS, VALIDATORS + 5)
STAGED_PAIRS = 4  # the altair staged route's pairs: three flags and the penalties
# Integer operations a validator, counted as the sweeps' are (a 64-bit add,
# compare or select 2, a product 3; each division by a fixed divisor
# DIV64_OPS, counted from the run's masks): the update as the B5-altair
# kernel's (INACTIVITY_UPDATES_OPS); a flag's masks and selects (6) and its
# two products; a pair's add, compare, subtraction and select.
STAGED_INACTIVITY_OPS = 12
STAGED_FLAG_OPS = 6 + 2 * 3
STAGED_PAIR_OPS = 8
# Bytes a validator: each input read once, each output written once.
STAGED_INACTIVITY_BYTES = 8 + 1 + 1 + 8
STAGED_FLAG_BYTES = 8 + 1 + 1 + 16
STAGED_APPLY_BYTES = 8 + 16 * STAGED_PAIRS + 8
# The flag cases of the run: (weight, unslashed increments, active
# increments, weight denominator, leaking, head flag); the last one's reward
# numerators pass 2^64.
STAGED_FLAG_CASES = (
    (14, 917_504, 1 << 25, 64, False, False),
    (14, 917_504, 1 << 25, 64, False, True),
    (26, 917_504, 1 << 25, 64, True, False),
    (2**64 - 1, 2**63 + 9, (1 << 50) + 3, 97, False, False),
)
STAGED_INACTIVITY_CASES = ((4, 16, False), (4, 16, True), (2**64 - 1, 2**64 - 2, False))
# The recorded apply's trace, in the git-ignored output directory.
TELEMETRY_TRACE = os.path.join("chiprun_out", "telemetry_trace.json")
# The prediction (PERF.md §6): the instrumentation of one recorded apply
# costs under 0.1 s, so on and off walls differ by the host's cold-apply
# spread, up to this share of the off wall.
RECORDING_PREDICTED_SHARE = 0.10


def _staged_columns(n: int, seed: int) -> dict:
    """Seeded host columns with u64 edge rows first: scores at 0, 1, the
    recovery rate and far above it (and where the bias wraps), base rewards
    whose products pass 2^64, balances where a reward's add wraps and
    penalties that saturate."""
    rng = np.random.default_rng(seed)
    top = 2**64 - 1

    def column(edges, high):
        col = rng.integers(0, high, n, dtype=np.uint64)
        col[:len(edges)] = np.asarray(edges, np.uint64)
        return col

    eligible = rng.random(n) < 0.9
    participating = rng.random(n) < 0.6
    eligible[:4], participating[:4] = [True, False, True, False], [True, True, False, False]
    return {
        "scores": column([0, 1, 16, 17, 2**32, 2**63, top - 3, top], 1 << 12),
        "base_reward": column([0, 1, 2**63, top, top // 14, 2**58], 1 << 40),
        "eligible": eligible,
        "participating": participating,
        "balances": column([0, 1, 32 * 10**9, 2**63, top - 5, top], 64 * 10**9),
        "pairs": [(column([top, 1, 0, 2**63], 1 << 31), column([0, top, 2**63, 5], 1 << 31))
                  for _ in range(STAGED_PAIRS)],
    }


def _staged_entries(n: int, seed: int) -> dict:
    """Each entry of ``epoch_vector.jitted_kernels()`` on the card at n
    (the host columns up, the result down), held bit-exact against its
    plain version on the same columns on the card; returns the largest
    word error of each entry."""
    from ethereum_consensus_tpu_torch.models import epoch_vector
    from ethereum_consensus_tpu_torch.ops import epoch as ops_epoch

    k = _staged_columns(n, seed)
    kernels = epoch_vector.jitted_kernels()
    scores, base, balances = (_cuda_column(k[c]) for c in ("scores", "base_reward", "balances"))
    elig, part = _cuda_column(k["eligible"]), _cuda_column(k["participating"])
    errs = {"staged_inactivity_scores": 0, "staged_flag_deltas": 0,
            "staged_apply_delta_pairs": 0}

    def err(got: np.ndarray, want: torch.Tensor) -> int:
        return _words_err(_cuda_column(got), want)

    for bias, recovery, leaking in STAGED_INACTIVITY_CASES:
        got = kernels["inactivity_scores"](k["scores"], k["eligible"], k["participating"],
                                           bias, recovery, leaking)
        want = ops_epoch.staged_inactivity_scores_plain(scores, elig, part, bias, recovery,
                                                        leaking)
        errs["staged_inactivity_scores"] = max(errs["staged_inactivity_scores"], err(got, want))
    for case in STAGED_FLAG_CASES:
        got = kernels["flag_deltas"](k["base_reward"], k["eligible"], k["participating"], *case)
        want = ops_epoch.staged_flag_deltas_plain(base, elig, part, *case)
        errs["staged_flag_deltas"] = max(errs["staged_flag_deltas"], err(got[0], want[0]),
                                         err(got[1], want[1]))
    got = kernels["apply_delta_pairs"](k["balances"], k["pairs"])
    rewards = torch.stack([_cuda_column(r) for r, _ in k["pairs"]])
    penalties = torch.stack([_cuda_column(p) for _, p in k["pairs"]])
    want = ops_epoch.staged_apply_delta_pairs_plain(balances, rewards, penalties)
    errs["staged_apply_delta_pairs"] = err(got, want)
    print(f"telemetry: staged entries n={n}: largest word error {errs}")
    return errs


def _staged_timings() -> dict:
    """CUDA-event times of the three staged kernels at 2^20 on the
    altair-shaped columns (the source flag; four pairs), beside their
    plain versions and their bounds."""
    from ethereum_consensus_tpu_torch.ops import epoch as ops_epoch

    n = VALIDATORS
    k = _staged_columns(n, seed=2100)
    scores, base, balances = (_cuda_column(k[c]) for c in ("scores", "base_reward", "balances"))
    elig, part = _cuda_column(k["eligible"]), _cuda_column(k["participating"])
    rewards = torch.stack([_cuda_column(r) for r, _ in k["pairs"]])
    penalties = torch.stack([_cuda_column(p) for _, p in k["pairs"]])
    weight, increments, active, wd, leaking, head = STAGED_FLAG_CASES[0]
    # a division for each lane that takes one: a reward where eligible and
    # unslashed, a penalty where eligible and not
    divisions = int(k["eligible"].sum())
    runs = {
        "staged_inactivity_scores": (
            lambda: ops_epoch.staged_inactivity_scores_cuda(scores, elig, part, 4, 16, False),
            lambda: ops_epoch.staged_inactivity_scores_plain(scores, elig, part, 4, 16, False),
            n * STAGED_INACTIVITY_OPS, n * STAGED_INACTIVITY_BYTES),
        "staged_flag_deltas": (
            lambda: ops_epoch.staged_flag_deltas_cuda(base, elig, part, weight, increments,
                                                      active, wd, leaking, head),
            lambda: ops_epoch.staged_flag_deltas_plain(base, elig, part, weight, increments,
                                                       active, wd, leaking, head),
            n * STAGED_FLAG_OPS + divisions * DIV64_OPS, n * STAGED_FLAG_BYTES),
        "staged_apply_delta_pairs": (
            lambda: ops_epoch.staged_apply_delta_pairs_cuda(balances, rewards, penalties),
            lambda: ops_epoch.staged_apply_delta_pairs_plain(balances, rewards, penalties),
            n * STAGED_PAIR_OPS * STAGED_PAIRS, n * STAGED_APPLY_BYTES),
    }
    out = {}
    for name, (launch, plain, ops, nbytes) in runs.items():
        ms = _cuda_ms(launch, reps=50, warmup=5)
        plain_ms = _cuda_ms(plain, reps=5, warmup=1)
        bound, bound_by = _bound(ops, nbytes)
        print(f"telemetry {name} n=2^20: {ms:.4f} ms, bound {bound:.4f} ms by {bound_by} "
              f"({100 * bound / ms:.1f}% of it); plain {plain_ms:.3f} ms; library: none")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by}
    return out


def _recorded_apply(registry: dict, signed_block) -> dict:
    """The phase0 block's device apply at 2^20, cold from SSZ, with spans
    recording and the device and memory observatories on, against the same
    apply with them off."""
    from ethereum_consensus_tpu_torch import convert, ops
    from ethereum_consensus_tpu_torch.telemetry import device, memory, metrics, phases, spans

    data, ctx = registry["data"], registry["ctx"]
    with _collector_paused():
        t0 = time.perf_counter()
        off_state = convert.state_from_ssz(data, ctx.preset)
        memory.start()  # arms the census's list tracking before the read
        on_state = convert.state_from_ssz(data, ctx.preset)
        memory.stop()
        read_s = time.perf_counter() - t0

    ops.uninstall()
    ops.install(device="cuda")
    off_s, _ = _apply(off_state, signed_block, ctx)
    ops.uninstall()
    ops.install(device="cuda")
    _zero_launch_counts()
    before = metrics.snapshot()
    spans.start_recording()
    device.start()
    memory.start()
    try:
        on_s, _ = _apply(on_state, signed_block, ctx)
    finally:
        memory.stop()
        device.stop()
        spans.stop_recording()
    counts = {name: c for name, c in _launch_counts().items() if c}
    after = metrics.snapshot()
    ops.uninstall()

    state_type = type(on_state)
    root_on = state_type.hash_tree_root(on_state)
    root_off = state_type.hash_tree_root(off_state)
    obs = device.OBSERVATORY
    ledger = obs.launches()
    transfers = obs.transfer_summary()["sites"]
    tallies = obs.route_tallies()

    def counted(name: str) -> int:
        return int(after.get(name, 0)) - int(before.get(name, 0))

    routes_agree = all(counted(f"device.route.{kind}.{choice}") == n
                       for kind, choices in tallies.items() for choice, n in choices.items())
    sites_ok = bool(transfers) and all(
        (agg["h2d_count"] == 0 or agg["h2d_bytes"] > 0)
        and (agg["d2h_count"] == 0 or agg["d2h_bytes"] > 0) for agg in transfers.values())
    records = spans.RECORDER.records()
    attribution = phases.attribution(records)
    total = attribution["slot_advance_s"] + attribution["block_apply_s"]
    parts = sum(attribution[k] for k in ("sig_batch_s", "state_htr_s", "committee_s",
                                         "operations_s"))
    buckets_ok = (set(attribution) == {"slot_advance_s", "block_apply_s", "sig_batch_s",
                                       "state_htr_s", "state_htr_in_slot_advance_s",
                                       "committee_s", "operations_s"}
                  and attribution["block_apply_s"] > 0 and abs(total - parts) <= 5e-4)
    doc = spans.RECORDER.chrome_trace()
    lanes = sorted(e["args"]["name"].split(" (")[0] for e in doc["traceEvents"]
                   if e.get("ph") == "M" and e.get("name") == "thread_name")
    os.makedirs(os.path.dirname(TELEMETRY_TRACE), exist_ok=True)
    with open(TELEMETRY_TRACE, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    audit = spans.RECORDER.audit()
    phase_ledger = memory.OBSERVATORY.phase_ledger()
    copies = memory.OBSERVATORY.copy_summary()["totals"]
    t0 = time.perf_counter()
    census = memory.census()
    census_s = time.perf_counter() - t0
    worst = memory.OBSERVATORY.worst(4, census)

    share = on_s / off_s - 1
    print(f"telemetry: states read in {read_s:.1f} s; cold device apply off {off_s:.3f} s, "
          f"recorded {on_s:.3f} s ({100 * share:+.1f}%; predicted within "
          f"{100 * RECORDING_PREDICTED_SHARE:.0f}%: "
          f"{'inside' if abs(share) <= RECORDING_PREDICTED_SHARE else 'OUTSIDE'})")
    print(f"telemetry: roots equal {root_on == root_off}, post-state root {root_on.hex()}")
    print(f"telemetry: attribution {attribution}")
    print(f"telemetry: launch ledger {ledger}; launch counts {counts}")
    print(f"telemetry: transfer sites { {s: (a['h2d_bytes'], a['d2h_bytes']) for s, a in transfers.items()} }")
    print(f"telemetry: route tallies {tallies}; counters agree {routes_agree}")
    print(f"telemetry: trace {TELEMETRY_TRACE}: {audit['spans']} spans, "
          f"{len(spans.RECORDER.event_records())} events, {audit['dropped']} dropped, "
          f"lanes {lanes}")
    print(f"telemetry: memory phases {sorted(phase_ledger)}; copies {copies}; census of the "
          f"2^20 state in {census_s:.3f} s, largest owners {worst}")
    failures = []
    if root_on != root_off:
        failures.append("the recorded apply's post-state root differs")
    if not buckets_ok:
        failures.append(f"phases.attribution lacks a bucket or does not add up: {attribution}")
    if ledger != counts:
        failures.append(f"the launch ledger {ledger} is not the launch counts {counts}")
    if not all(counts.get(k) for k in ("sha256_64b", "shuffle", "g1_sum_sets")):
        failures.append(f"a kernel of the block path was not launched: {counts}")
    if not sites_ok:
        failures.append(f"a transfer site lacks its bytes: {transfers}")
    if not routes_agree or not tallies:
        failures.append(f"the route tallies and the device.route.* counters disagree: {tallies}")
    if "device" not in lanes:
        failures.append(f"the trace has no device lane: {lanes}")
    if failures:
        sys.exit("chip_smoke: " + "; ".join(failures))
    return {"read_s": read_s, "off_s": off_s, "on_s": on_s, "share": share,
            "root": root_on.hex(), "attribution": attribution, "launches": counts,
            "spans": audit["spans"], "dropped": audit["dropped"], "lanes": lanes,
            "census_s": census_s}


def phase_telemetry(registry: dict, signed_block) -> dict:
    """The staged epoch kernels through ``epoch_vector.jitted_kernels()`` at
    2^20 and 2^20 + 5, bit-exact against their plain versions on the card and
    timed at 2^20; then the phase0 block's device apply recorded."""
    _zero_launch_counts()
    errs = [_staged_entries(n, seed=2100 + i) for i, n in enumerate(STAGED_SIZES)]
    counts = _launch_counts()
    launches = {name: counts[name] for name in errs[0]}
    print(f"telemetry: staged launches through jitted_kernels() {launches}")
    if not all(launches.values()):
        sys.exit(f"chip_smoke: a staged kernel was never launched: {launches}")
    worst = {name: max(e[name] for e in errs) for name in launches}
    if any(worst.values()):
        sys.exit(f"chip_smoke: a staged kernel differs from its plain version: {worst}")
    timings = _staged_timings()
    for name in timings:
        timings[name]["max_abs_err"] = worst[name]
    recorded = _recorded_apply(registry, signed_block)
    return {"launches": launches, "timings": timings, "recorded": recorded}


def _hysteresis_columns(n: int, gen: torch.Generator, scalars: tuple) -> tuple:
    """(balances, effective) int64 words on the card: realistic balances
    around multiples of the increment, each threshold +-1, and words at and
    above 2^63 (whose sums with a threshold wrap past 2^64)."""
    increment, _cap, down, up = scalars
    def ints(low, high):
        return torch.randint(low, high, (n,), dtype=torch.int64, device="cuda", generator=gen)
    eff = ints(0, 33) * increment
    near = ints(-1, 2)
    high = ints(-(2**63), 0)  # the words of 2^63 .. 2^64 - 1
    cases = [
        eff + ints(-increment, 2 * increment),  # realistic
        eff - down + near,                      # downward threshold +-1
        eff + up + near,                        # upward threshold +-1
        high,                                   # balances >= 2^63
        -1 - ints(0, up + 2),                   # near 2^64: bal + down wraps
    ]
    kind = ints(0, len(cases))
    bal = torch.zeros_like(eff)
    for k, case in enumerate(cases):
        bal = torch.where(kind == k, case, bal)
    # a few effective balances near 2^64 too: eff + up wraps
    eff = torch.where(ints(0, 16) == 0, -1 - ints(0, up + 2), eff)
    return bal.contiguous(), eff.contiguous()


def _hysteresis_int(balance: int, effective: int, scalars: tuple) -> int:
    """The spec's update of one validator in Python integers, u64 wraps
    included."""
    increment, cap, down, up = scalars
    top = 1 << 64
    if (balance + down) % top < effective or (effective + up) % top < balance:
        return min(balance - balance % increment, cap)
    return effective


def phase_sweeps() -> dict:
    from ethereum_consensus_tpu_torch.config import Context
    from ethereum_consensus_tpu_torch.ops import sweeps

    ctx = Context.for_mainnet()
    scalars = sweeps.hysteresis_scalars(ctx)
    gen = torch.Generator(device="cuda").manual_seed(20261017)
    rng = np.random.default_rng(5)
    checks = []
    for n in SWEEPS_CHECK_NS:
        bal, eff = _hysteresis_columns(n, gen, scalars)
        got = sweeps.effective_balance_updates(bal, eff, ctx)
        torch.cuda.synchronize()
        plain = sweeps.effective_balance_updates_plain(bal, eff, ctx)
        wrong = (got != plain).nonzero().flatten()
        u64 = (1 << 64) - 1
        err = max((abs((int(got[i]) & u64) - (int(plain[i]) & u64)) for i in wrong.tolist()),
                  default=0)
        sample = sorted({0, n - 1, *rng.integers(0, n, 64).tolist()})
        bal_h, eff_h, got_h = (t[sample].cpu().tolist() for t in (bal, eff, got))
        oracle_ok = all(
            _hysteresis_int(b & u64, e & u64, scalars) == g & u64
            for b, e, g in zip(bal_h, eff_h, got_h)
        )
        changed = int((got != eff).sum())
        print(f"sweeps n={n}: max_abs_err vs plain {err}, Python sample ok {oracle_ok}, "
              f"{changed} effective balances changed")
        if err != 0 or not oracle_ok:
            sys.exit(f"chip_smoke: the hysteresis kernel disagrees at n={n}")
        checks.append({"n": n, "max_abs_err": err, "changed": changed})
        # one and two rows in: every column off the warp chunks, then on them
        for offset in (1, 2):
            got = sweeps.effective_balance_updates(bal[offset:], eff[offset:], ctx)
            torch.cuda.synchronize()
            wrong = int((got != sweeps.effective_balance_updates_plain(
                bal[offset:], eff[offset:], ctx)).sum())
            if wrong:
                sys.exit(f"chip_smoke: the hysteresis kernel disagrees at n={n}, "
                         f"offset {offset}: {wrong} words")
    print(f"sweeps: the kernel matches its plain version one and two rows in at every n")
    # the last n checked is the main path's, 2^20
    ms = _cuda_ms(lambda: sweeps._launch(bal, eff, scalars), reps=50, warmup=5)
    bound, bound_by = sweeps_bound_ms(n)
    copy_ms, empty_ms = _yardsticks(n * SWEEPS_BYTES_PER_VALIDATOR)
    plain_ms = _cuda_ms(lambda: sweeps.effective_balance_updates_plain(bal, eff, ctx),
                        reps=5, warmup=1)
    print(f"sweeps n=2^20: {ms:.4f} ms (bound {bound:.4f} ms by {bound_by}); a copy of its "
          f"{SWEEPS_BYTES_PER_VALIDATOR} bytes a validator {copy_ms:.4f} ms, an empty launch "
          f"{empty_ms:.4f} ms; plain {plain_ms:.3f} ms; library: none")
    compiled = _sweep_ptxas("sweeps", "effective_balance_kernel")
    return {"checks": checks, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "copy_ms": copy_ms, "empty_ms": empty_ms, "ptxas": compiled,
            "max_abs_err": max(c["max_abs_err"] for c in checks)}


def _sweep_ptxas(library: str, kernel: str) -> dict:
    """ptxas' lines and the SASS instructions of B5-hysteresis or the
    inactivity updates (``kernel`` in ``library``); a frame or a spill fails
    the run."""
    ptxas = _ptxas_lines(library, kernel)
    sass = {"kernel": _sass_kernel_instructions(library, (kernel,)),
            "library": _sass_instructions(library)}
    print(f"{kernel}: ptxas {ptxas}; SASS instructions {sass}")
    if not ptxas or any(line.get("spill_stores") or line.get("stack_frame") for line in ptxas):
        sys.exit(f"chip_smoke: ptxas gives {kernel} a frame or spills")
    return {"ptxas": ptxas, "sass": sass}


def _sass_instructions(name: str, path: "str | None" = None) -> "int | None":
    """Instructions in the SASS of a built kernel library (static count,
    every path of the division routine included), or None without
    cuobjdump. From ``path`` when given, else the library's build."""
    from ethereum_consensus_tpu_torch import _kernels

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", path or _kernels._paths(name)[0]], check=True,
                          capture_output=True, text=True).stdout
    return sum(1 for line in sass.splitlines() if line.strip().startswith("/*")
               and "*/" in line and line.strip()[2:6].strip("0123456789abcdef") == "")


def _sass_kernel_instructions(name: str, kernels: tuple) -> "dict | None":
    """Instructions in the SASS of each kernel of a built library whose
    (mangled) name holds one of ``kernels``, or None without cuobjdump."""
    from ethereum_consensus_tpu_torch import _kernels

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", _kernels._paths(name)[0]], check=True,
                          capture_output=True, text=True).stdout
    out, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            function = line.split("Function :")[1].strip()
            current = function if any(k in function for k in kernels) else None
            if current:
                out[current] = 0
        elif current and line.strip().startswith("/*") and "*/" in line and \
                line.strip()[2:6].strip("0123456789abcdef") == "":
            out[current] += 1
    return out


def inject_full_epoch_pendings(state, ctx, epoch: int) -> int:
    """Full-participation pending attestations for every (slot, committee)
    of ``epoch`` that the state's slot has included, unsigned (epoch
    processing never verifies them), as tests/chain_utils.py:1257 builds
    them. Returns the count."""
    from ethereum_consensus_tpu_torch.models.phase0 import build
    from ethereum_consensus_tpu_torch.models.phase0 import helpers as h

    ns = build(ctx.preset)
    spe = int(ctx.SLOTS_PER_EPOCH)
    start = epoch * spe
    per_slot = h.get_committee_count_per_slot(state, epoch, ctx)
    if epoch == h.get_current_epoch(state, ctx):
        source, pendings = (state.current_justified_checkpoint.copy(),
                            state.current_epoch_attestations)
    else:
        source, pendings = (state.previous_justified_checkpoint.copy(),
                            state.previous_epoch_attestations)
    target_root = h.get_block_root_at_slot(state, start)
    n = 0
    for slot in range(start, start + spe):
        if slot + int(ctx.MIN_ATTESTATION_INCLUSION_DELAY) > state.slot:
            continue
        block_root = h.get_block_root_at_slot(state, slot)
        for index in range(per_slot):
            committee = h.get_beacon_committee(state, slot, index, ctx)
            pendings.append(ns.PendingAttestation(
                aggregation_bits=[True] * len(committee),
                data=ns.AttestationData(
                    slot=slot, index=index, beacon_block_root=block_root, source=source,
                    target=ns.Checkpoint(epoch=epoch, root=target_root),
                ),
                inclusion_delay=int(ctx.MIN_ATTESTATION_INCLUSION_DELAY),
                proposer_index=committee[0],
            ))
            n += 1
    return n


def scramble_registry(state, ctx, seed: int) -> dict:
    """Registry churn for the boundary into epoch 3, leaving every active
    set up to epoch 2 as it was: effective balances that cross the
    hysteresis thresholds both ways, ejection candidates, slashed
    validators at the penalty halfway point, future exits, and appended
    entrants (queue entries and finalized-eligible activations)."""
    from ethereum_consensus_tpu_torch.models.phase0 import build
    from ethereum_consensus_tpu_torch.primitives import FAR_FUTURE_EPOCH

    ns = build(ctx.preset)
    rng = np.random.default_rng(seed)
    n = len(state.validators)
    inc = int(ctx.EFFECTIVE_BALANCE_INCREMENT)
    down, up = inc // 4, 5 * inc // 4
    picks = rng.choice(n, 3232, replace=False).tolist()
    # ejections stay few: the literal route's initiate_validator_exit walks
    # the whole registry once per ejection, as the reference's does; 32 is
    # twice the exit churn of a 2^20 registry
    downs, ups, ejects, slashed, exits = (picks[:1536], picks[1536:3072], picks[3072:3104],
                                          picks[3104:3168], picks[3168:3232])
    for i in downs:  # balance falls through the downward threshold
        state.balances[i] = int(state.validators[i].effective_balance) - down - inc // 10
    for i in ups:  # lower effective balance, balance above the upward one
        state.validators[i].effective_balance = 20 * inc
        state.balances[i] = 20 * inc + up + inc // 10
    for i in ejects:
        state.validators[i].effective_balance = int(ctx.ejection_balance)
    half = int(ctx.EPOCHS_PER_SLASHINGS_VECTOR) // 2
    for i in slashed:
        state.validators[i].slashed = True
        state.validators[i].withdrawable_epoch = 2 + half
    state.slashings[2] = 64 * int(ctx.MAX_EFFECTIVE_BALANCE)
    for i in exits:
        state.validators[i].exit_epoch = 10
        state.validators[i].withdrawable_epoch = 10 + int(ctx.min_validator_withdrawability_delay)
    for k in range(256):
        state.validators.append(ns.Validator(
            public_key=_synthetic_pubkey(n + k),
            withdrawal_credentials=b"\x00" * 32,
            effective_balance=int(ctx.MAX_EFFECTIVE_BALANCE),
            activation_eligibility_epoch=FAR_FUTURE_EPOCH if k % 2 else 0,
            activation_epoch=FAR_FUTURE_EPOCH,
            exit_epoch=FAR_FUTURE_EPOCH,
            withdrawable_epoch=FAR_FUTURE_EPOCH,
        ))
        state.balances.append(int(ctx.MAX_EFFECTIVE_BALANCE))
    for key in ("_active_idx_cache", "_proposer_cache", "_total_active_balance_cache",
                "_pending_masks_memo"):
        state.__dict__.pop(key, None)
    return {"downward": len(downs), "upward": len(ups), "ejections": len(ejects),
            "slashed": len(slashed), "exits": len(exits), "entrants": 256}


def _effective_balances(state) -> np.ndarray:
    return np.fromiter((v.effective_balance for v in state.validators), np.uint64,
                       len(state.validators))


def _cross(state, ctx, timers: list, events: "list | None") -> tuple[float, dict]:
    """process_slots over the boundary with host timers on ``timers``
    ((module, name, key) triples) and CUDA events on each kernel launch."""
    from ethereum_consensus_tpu_torch.models import transition
    from ethereum_consensus_tpu_torch.models.phase0 import slot_processing
    from ethereum_consensus_tpu_torch.ops import sha256, shuffle, sweeps

    parts: dict = {}
    with contextlib.ExitStack() as stack:
        for module, name, key in [(transition, "process_slot_generic", "slot_root"), *timers]:
            stack.enter_context(_patched(module, name, _host_timer(parts, key)))
        if events is not None:
            for module, name, key in ((sha256, "sha256_64b_cuda", "sha256_64b"),
                                      (shuffle, "_launch", "shuffle"),
                                      (sweeps, "_launch", "effective_balance")):
                stack.enter_context(_patched(module, name, _event_timer(events, key)))
        gc.collect()
        gc.freeze()
        try:
            t0 = time.perf_counter()
            slot_processing.process_slots(state, EPOCH_PRE_SLOT + 1, ctx)
            if events is not None:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            gc.unfreeze()
    return seconds, parts


def phase_epoch(registry: dict) -> dict:
    """The slice's main path: the boundary into epoch 3 of a 2^20-validator
    phase0 state with full pending attestations, on the host path (the
    columnar engine) and with the kernels installed (the literal stages,
    hysteresis on the card)."""
    from ethereum_consensus_tpu_torch import convert, ops
    from ethereum_consensus_tpu_torch.models import committees, epoch_vector
    from ethereum_consensus_tpu_torch.models.phase0 import epoch_processing as pep
    from ethereum_consensus_tpu_torch.models.phase0 import slot_processing
    from ethereum_consensus_tpu_torch.ops import g1, sha256, shuffle, sweeps
    from ethereum_consensus_tpu_torch.telemetry import metrics

    ctx = registry["ctx"]
    ops.uninstall()
    with _collector_paused():
        t0 = time.perf_counter()
        state = _setup_state(registry)
        slot_processing.process_slots(state, EPOCH_SCRAMBLE_SLOT, ctx)
        to_64_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        scrambled = scramble_registry(state, ctx, seed=3)
        slot_processing.process_slots(state, EPOCH_PRE_SLOT, ctx)
        to_95_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pendings = {epoch: inject_full_epoch_pendings(state, ctx, epoch) for epoch in (1, 2)}
        pre = type(state).serialize(state)
        inject_s = time.perf_counter() - t0
        eff_before = _effective_balances(state)
        n = len(state.validators)
        del state
        t0 = time.perf_counter()
        host_state = convert.state_from_ssz(pre, ctx.preset)
        device_state = convert.state_from_ssz(pre, ctx.preset)
        read_s = time.perf_counter() - t0
    print(f"epoch: {n} validators; slots 0..{EPOCH_SCRAMBLE_SLOT} {to_64_s:.1f} s; scramble "
          f"{scrambled} and slots to {EPOCH_PRE_SLOT} {to_95_s:.1f} s; pendings {pendings} "
          f"and serialize ({len(pre)} bytes) {inject_s:.1f} s; two reads {read_s:.1f} s")

    engaged = metrics.counter("epoch_vector.epochs")
    declined = metrics.counter("epoch_vector.fallback.device_sweeps")
    host_stages = [(epoch_vector, name, name.strip("_")) for name in (
        "_justification_phase0", "_rewards_phase0", "_registry_updates", "_slashings",
        "_effective_balance_updates", "_commit")] + [(committees, "_build", "mask_build")]
    ops.uninstall()
    before = (engaged.value(), declined.value())
    host_s, host_parts = _cross(host_state, ctx, host_stages, None)
    host_engaged = engaged.value() - before[0]

    device_stages = [(pep, name, name) for name in (
        "process_justification_and_finalization", "process_rewards_and_penalties",
        "process_registry_updates", "process_slashings",
        "process_effective_balance_updates")] + [
        (committees, "_build", "mask_build"), (sweeps, "pack_registry", "pack"),
        (sweeps, "effective_balance_updates_device", "kernel_call")]
    ops.uninstall()  # clears the shuffle cache: the device run shuffles anew
    ops.install(device="cuda")
    events: list = []
    before = (engaged.value(), declined.value())
    _zero_launch_counts()
    device_s, device_parts = _cross(device_state, ctx, device_stages, events)
    launches = _launch_counts()
    ops.uninstall()
    device_engaged = engaged.value() - before[0]
    device_declined = declined.value() - before[1]
    kernel_ms: dict = {}
    for name, start, end in events:
        kernel_ms[name] = kernel_ms.get(name, 0.0) + start.elapsed_time(end)
    device_parts["write_back"] = (device_parts["process_effective_balance_updates"]
                                  - device_parts["pack"] - device_parts["kernel_call"])
    idle = 1.0 - sum(kernel_ms.values()) / (1e3 * device_s)

    state_type = type(host_state)
    same_bytes = state_type.serialize(host_state) == state_type.serialize(device_state)
    root = state_type.hash_tree_root(device_state)
    same_root = root == state_type.hash_tree_root(host_state)
    changed = int((_effective_balances(device_state)[:n] != eff_before).sum())
    print(f"epoch: host {host_s:.3f} s {_rounded(host_parts)}; columnar passes {host_engaged}")
    print(f"epoch: device {device_s:.3f} s {_rounded(device_parts)}; columnar passes "
          f"{device_engaged}, device_sweeps declines {device_declined}; launches {launches}; "
          f"kernel ms inside {_rounded(kernel_ms, 4)}; idle share {idle:.6f}")
    print(f"epoch: bytes equal {same_bytes}, roots equal {same_root}, {changed} effective "
          f"balances changed, post-state root {root.hex()}")
    if not (same_bytes and same_root):
        sys.exit("chip_smoke: the epoch boundary differs between host and device")
    if host_engaged != 1 or device_engaged != 0 or device_declined != 1:
        sys.exit("chip_smoke: the columnar engine did not take the expected routes")
    if launches["effective_balance"] != 1 or launches["sha256_64b"] == 0:
        sys.exit(f"chip_smoke: a kernel of the epoch path was not launched: {launches}")
    if changed == 0:
        sys.exit("chip_smoke: no effective balance changed at the boundary")
    return {"validators": n, "pendings": pendings, "scrambled": scrambled,
            "state_bytes": len(pre), "to_64_s": to_64_s, "to_95_s": to_95_s,
            "inject_s": inject_s, "read_s": read_s, "host_s": host_s,
            "host_parts_s": host_parts, "device_s": device_s, "device_parts_s": device_parts,
            "launches": launches, "kernel_ms_inside": kernel_ms, "idle_share": idle,
            "effective_balances_changed": changed, "root": root.hex()}


def _zero_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from ethereum_consensus_tpu_torch.ops import (chain_step, epoch, fq8, g1, merkle, pairing,
                                                  sha256, shuffle, sweeps)

    sha256.launch_count = shuffle.launch_count = g1.launch_count = epoch.launch_count = 0
    g1.launch_count_mxu = merkle.launch_count = 0
    for counts in (sweeps.launch_counts, pairing.launch_counts, fq8.launch_counts,
                   epoch.launch_counts, chain_step.launch_counts):
        for name in counts:
            counts[name] = 0


def _launch_counts() -> dict:
    """Every kernel's launches since ``_zero_launch_counts``."""
    from ethereum_consensus_tpu_torch.ops import (chain_step, epoch, fq8, g1, merkle, pairing,
                                                  sha256, shuffle, sweeps)

    return {"sha256_64b": sha256.launch_count, "merkle_levels": merkle.launch_count,
            "shuffle": shuffle.launch_count, "g1_sum_sets": g1.launch_count,
            "fused_epoch": epoch.launch_count, **epoch.launch_counts,
            **sweeps.launch_counts, **pairing.launch_counts,
            "g1_sum_sets_mxu": g1.launch_count_mxu, **fq8.launch_counts,
            **chain_step.launch_counts}


# --- the altair sweeps and the fused epoch kernel -------------------------

# Mainnet scalars of the altair epoch pass (a 2^20-validator registry of
# 32 ETH): base reward factor, weight denominator, inactivity bias and
# recovery rate, the altair inactivity-penalty quotient, the flag weights.
ALTAIR_INCREMENT = 10**9
ALTAIR_TOTAL_ACTIVE = (1 << 20) * 32 * ALTAIR_INCREMENT
ALTAIR_BIAS, ALTAIR_RECOVERY, ALTAIR_QUOTIENT = 4, 16, 3 * 2**24
ALTAIR_WEIGHTS, ALTAIR_WD, ALTAIR_BRF = (14, 26, 14), 64, 64
ALTAIR_CHECK_NS = SWEEPS_CHECK_NS
# the flag deltas and the penalties also past their grids' first chunk a
# warp, where a warp takes more than one chunk
FLAG_WIDE_N = (1 << 21) + 5
# the penalties also timed at a 4-shard share of the registry
PENALTIES_QUARTER_N = 1 << 18
# Integer operations, counted as SWEEPS_OPS_PER_VALIDATOR is: a 64-bit add,
# subtraction, compare or select is 2, a 64 x 64 -> 64 product 3, and a
# division by a value fixed for the whole sweep a Barrett reduction with a
# precomputed reciprocal (the high product in 8, the product back in 3, the
# subtraction 2, one conditional correction 4). Divisions are counted per
# validator from the run's masks (only the lanes that need one); the rest
# per validator:
#   flag deltas: the base reward, the reward numerator and the penalty
#     product (12), the flag and mask logic and two selects (6);
#   inactivity updates: min, subtraction, addition, three selects, the
#     recovery min and subtraction (12);
#   inactivity penalties: the product and a select (5);
#   fused: the masks (3), the inactivity update (8), the base reward (3),
#     per flag the products (9), selects and the saturating application
#     with its wrap test (16), then the penalty product and its application
#     (9).
DIV64_OPS = 8 + 3 + 2 + 4
FLAG_DELTAS_OPS = 18
INACTIVITY_UPDATES_OPS = 12
INACTIVITY_PENALTIES_OPS = 5
FUSED_OPS = 3 + 8 + 3 + 3 * (9 + 16) + 9
# Bytes each function must move a validator: every input read once, every
# output written once (words 8, flags 1).
FLAG_DELTAS_BYTES = 8 + 1 + 1 + 16
INACTIVITY_UPDATES_BYTES = 8 + 1 + 1 + 8
INACTIVITY_PENALTIES_BYTES = 8 + 8 + 1 + 8
FUSED_BYTES = 3 * 8 + 1 + 3 + 2 * 8


def _altair_columns(n: int, gen: torch.Generator) -> dict:
    """Seeded columns on the card: realistic effective balances with a
    share of words at and above 2^63 (their reward products pass 2^64),
    balances around them, low ones that a penalty saturates and some near
    2^64 whose adds wrap, scores at 0, 1, the recovery rate and far above it
    and near 2^64, mixed flags, slashed and ineligible lanes."""
    def ints(low, high):
        return torch.randint(low, high, (n,), dtype=torch.int64, device="cuda", generator=gen)

    def pick(cases):
        kind = ints(0, len(cases))
        out = torch.zeros_like(kind)
        for k, case in enumerate(cases):
            out = torch.where(kind == k, case, out)
        return out

    inc = ALTAIR_INCREMENT
    eff = ints(0, 33) * inc
    eff = torch.where(ints(0, 8) == 0, ints(-(2**63), 2**63 - 1), eff)
    balances = pick([eff + ints(-inc, 2 * inc), ints(0, 1 << 20), -1 - ints(0, 1 << 12),
                     eff + ints(0, inc)])
    scores = pick([ints(0, 3), ALTAIR_RECOVERY + ints(-2, 3), ints(0, 1 << 32),
                   -1 - ints(0, 8), ints(0, 64)])
    prev_part = ints(0, 8).to(torch.uint8)
    slashed = ints(0, 20) == 0
    active_prev = ints(0, 20) != 0
    eligible = ints(0, 25) != 0
    participating = active_prev & ~slashed & ((prev_part >> 1) & 1).bool()
    return {"eff": eff, "balances": balances, "scores": scores, "prev_part": prev_part,
            "slashed": slashed, "active_prev": active_prev, "eligible": eligible,
            "participating": participating}


def _fused_scalars(leaking: bool) -> tuple:
    from ethereum_consensus_tpu_torch.ops import sweeps

    brpi = ALTAIR_INCREMENT * ALTAIR_BRF // sweeps.isqrt_u64(ALTAIR_TOTAL_ACTIVE)
    return (ALTAIR_INCREMENT, brpi, ALTAIR_TOTAL_ACTIVE // ALTAIR_INCREMENT,
            ALTAIR_BIAS * ALTAIR_QUOTIENT, ALTAIR_BIAS, ALTAIR_RECOVERY, ALTAIR_WEIGHTS,
            ALTAIR_WD, leaking, 2, 1)


def _u64_lanes(t: torch.Tensor, idx: list) -> list:
    return [v & ((1 << 64) - 1) for v in t[idx].cpu().tolist()]


def _fused_lane_int(bal, eff, part, slashed, active, elig, score, sums, scalars) -> tuple:
    """One validator through the fused epoch pass in Python integers, u64
    wraps included (the reference's fused_epoch_kernel, one lane)."""
    m = (1 << 64) - 1
    inc, brpi, active_incr, denom, bias, rec, weights, wd, leaking, head, target = scalars
    unslashed_all = active and not slashed
    participating = unslashed_all and bool(part >> target & 1)
    if elig:
        score = score - min(1, score) if participating else (score + bias) & m
        if not leaking:
            score -= min(rec, score)
    base = (eff // inc) * brpi & m
    wrapped = 0
    for f, w in enumerate(weights):
        unslashed = unslashed_all and bool(part >> f & 1)
        increments = max(inc, sums[f]) // inc
        reward = (base * w * increments & m) // (active_incr * wd & m) if (
            not leaking and elig and unslashed) else 0
        penalty = (base * w & m) // wd if (f != head and elig and not unslashed) else 0
        raised = (bal + reward) & m
        wrapped += raised < bal
        bal = raised - penalty if raised >= penalty else 0
    penalty = (eff * score & m) // denom if (elig and not participating) else 0
    bal = bal - penalty if bal >= penalty else 0
    return score, bal, wrapped


def _sweep_timing(name: str, launch, plain, n: int, divisions: int, ops_per: int,
                  bytes_per: int) -> dict:
    ms = _cuda_ms(launch, reps=50, warmup=5)
    plain_ms = _cuda_ms(plain, reps=5, warmup=1)
    bound, bound_by = _bound(n * ops_per + divisions * DIV64_OPS, n * bytes_per)
    print(f"altair_sweeps {name} n=2^20: {ms:.4f} ms (bound {bound:.4f} ms by {bound_by}, "
          f"{divisions} divisions); plain {plain_ms:.3f} ms; library: none")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "divisions": divisions}


def _flag_sample_ok(eff, participating, got, sample: list, lanes: tuple, flag: int,
                    leaking: bool) -> bool:
    """The sampled lanes of a flag-delta call ``got`` against Python
    integers: the masked sum, the sweep's scalars, then each lane. ``lanes``
    holds the sampled (eff, participating, eligible) as Python values."""
    from ethereum_consensus_tpu_torch.ops import sweeps

    m = (1 << 64) - 1
    total = sum(v & m for v in eff[participating].cpu().tolist()) & m
    brpi = ALTAIR_INCREMENT * ALTAIR_BRF // sweeps.isqrt_u64(ALTAIR_TOTAL_ACTIVE)
    incr = total // ALTAIR_INCREMENT
    divisor = ALTAIR_TOTAL_ACTIVE // ALTAIR_INCREMENT * ALTAIR_WD
    w = ALTAIR_WEIGHTS[flag]
    ok = True
    for e, p, el, r, pe in zip(*lanes, _u64_lanes(got[0], sample), _u64_lanes(got[1], sample)):
        base = (e // ALTAIR_INCREMENT) * brpi & m
        want_r = (base * w * incr & m) // divisor if p and el and not leaking else 0
        want_p = (base * w & m) // ALTAIR_WD if flag != 2 and el and not p else 0
        ok &= (r, pe) == (want_r, want_p)
    return ok


def phase_altair_sweeps() -> dict:
    """B3 and the three B5-altair kernels against their plain versions on
    the card, bit-exact, for n in ALTAIR_CHECK_NS, and the flag deltas, the
    inactivity penalties and B3 at FLAG_WIDE_N, contiguous and one validator
    in; samples against Python integers; CUDA-event times at 2^20 (the
    penalties also at 2^18); ptxas' lines of the penalties, B3, its apply
    entries and K3 (a frame or a spill fails the run)."""
    from ethereum_consensus_tpu_torch.ops import epoch, sweeps

    m = (1 << 64) - 1
    gen = torch.Generator(device="cuda").manual_seed(20261018)
    rng = np.random.default_rng(6)
    errs = {"fused_epoch": 0, "flag_deltas": 0, "inactivity_updates": 0,
            "inactivity_penalties": 0}
    denominator = ALTAIR_BIAS * ALTAIR_QUOTIENT

    def err(got, want) -> int:
        wrong = (got != want).nonzero().flatten().tolist()
        return max((abs((int(got[i]) & m) - (int(want[i]) & m)) for i in wrong), default=0)

    for n in ALTAIR_CHECK_NS:
        c = _altair_columns(n, gen)
        sample = sorted({0, n - 1, *rng.integers(0, n, 48).tolist()})
        eff_h, part_h, elig_h = (_u64_lanes(c["eff"], sample), c["participating"][sample].tolist(),
                                 c["eligible"][sample].tolist())
        checks_ok, wraps = True, 0
        for leaking in (False, True):
            for flag in range(3):
                args = (ALTAIR_TOTAL_ACTIVE, ALTAIR_WEIGHTS[flag], ALTAIR_INCREMENT, ALTAIR_BRF,
                        ALTAIR_WD, leaking, flag == 2)
                got = sweeps.flag_deltas(c["eff"], c["participating"], c["eligible"], *args)
                torch.cuda.synchronize()
                want = sweeps.flag_deltas_plain(c["eff"], c["participating"], c["eligible"], *args)
                errs["flag_deltas"] = max(errs["flag_deltas"], err(got[0], want[0]),
                                          err(got[1], want[1]))
                checks_ok &= _flag_sample_ok(c["eff"], c["participating"], got, sample,
                                             (eff_h, part_h, elig_h), flag, leaking)
            got = sweeps.inactivity_updates(c["scores"], c["participating"], c["eligible"],
                                            ALTAIR_BIAS, ALTAIR_RECOVERY, leaking)
            torch.cuda.synchronize()
            want = sweeps.inactivity_updates_plain(c["scores"], c["participating"], c["eligible"],
                                                   ALTAIR_BIAS, ALTAIR_RECOVERY, leaking)
            errs["inactivity_updates"] = max(errs["inactivity_updates"], err(got, want))
            # one and two rows in: every column off the warp chunks, then on them
            for offset in (1, 2):
                cols = [c[k][offset:] for k in ("scores", "participating", "eligible")]
                got_off = sweeps.inactivity_updates(*cols, ALTAIR_BIAS, ALTAIR_RECOVERY, leaking)
                torch.cuda.synchronize()
                errs["inactivity_updates"] = max(errs["inactivity_updates"], err(
                    got_off, sweeps.inactivity_updates_plain(*cols, ALTAIR_BIAS, ALTAIR_RECOVERY,
                                                             leaking)))
            for s, p, el, g in zip(_u64_lanes(c["scores"], sample), part_h, elig_h,
                                   _u64_lanes(got, sample)):
                if el:
                    s = s - min(1, s) if p else (s + ALTAIR_BIAS) & m
                    if not leaking:
                        s -= min(ALTAIR_RECOVERY, s)
                checks_ok &= s == g
            scalars = _fused_scalars(leaking)
            columns = [c[k] for k in ("balances", "eff", "prev_part", "slashed", "active_prev",
                                      "eligible", "scores")]
            got = epoch.fused_epoch(*columns, *scalars)
            torch.cuda.synchronize()
            want = epoch.fused_epoch_plain(*columns, *scalars)
            errs["fused_epoch"] = max(errs["fused_epoch"], err(got[0], want[0]),
                                      err(got[1], want[1]), abs(got[2] - want[2]))
            unslashed = c["active_prev"] & ~c["slashed"]
            sums = [sum(v & m for v in c["eff"][unslashed & ((c["prev_part"] >> f) & 1).bool()]
                        .cpu().tolist()) & m for f in range(3)]
            lanes = zip(*(_u64_lanes(col, sample) if col.dtype == torch.int64
                          else col[sample].tolist() for col in columns))
            for lane, s_got, b_got in zip(lanes, _u64_lanes(got[0], sample),
                                          _u64_lanes(got[1], sample)):
                bal, e, part, sl, act, el, sc = lane
                s_want, b_want, w = _fused_lane_int(bal, e, part, sl, act, el, sc, sums, scalars)
                checks_ok &= (s_got, b_got) == (s_want, b_want)
                wraps += w
        not_target = c["eligible"] & ~c["participating"]
        got = sweeps.inactivity_penalties(c["eff"], c["scores"], not_target, denominator)
        torch.cuda.synchronize()
        want = sweeps.inactivity_penalties_plain(c["eff"], c["scores"], not_target, denominator)
        errs["inactivity_penalties"] = max(errs["inactivity_penalties"], err(got, want))
        nt_h = not_target[sample].tolist()
        for e, s, nt, g in zip(eff_h, _u64_lanes(c["scores"], sample), nt_h,
                               _u64_lanes(got, sample)):
            checks_ok &= g == ((e * s & m) // denominator if nt else 0)
        print(f"altair_sweeps n={n}: max_abs_err vs plain {errs} (the updates also one and two "
              f"rows in), Python sample ok {checks_ok} ({wraps} wrapped adds in the sampled fused "
              f"lanes)")
        if any(errs.values()) or not checks_ok:
            sys.exit(f"chip_smoke: an altair sweep kernel disagrees at n={n}")

    # Past the co-resident grid (4 blocks an SM of 2,048 validators: about
    # 1.08M on an H100) a warp of the flag deltas takes more than one chunk
    # and reads its later chunks again; a view one validator in takes the
    # one-validator path, as an unaligned column does at any n.
    wide = _altair_columns(FLAG_WIDE_N, gen)
    for offset in (0, 1):
        cols = [wide[k][offset:] for k in ("eff", "participating", "eligible")]
        n = FLAG_WIDE_N - offset
        sample = sorted({0, n - 1, *rng.integers(0, n, 48).tolist()})
        lanes = (_u64_lanes(cols[0], sample), cols[1][sample].tolist(), cols[2][sample].tolist())
        checks_ok = True
        for leaking in (False, True):
            for flag in range(3):
                args = (ALTAIR_TOTAL_ACTIVE, ALTAIR_WEIGHTS[flag], ALTAIR_INCREMENT, ALTAIR_BRF,
                        ALTAIR_WD, leaking, flag == 2)
                got = sweeps.flag_deltas(*cols, *args)
                torch.cuda.synchronize()
                want = sweeps.flag_deltas_plain(*cols, *args)
                errs["flag_deltas"] = max(errs["flag_deltas"], err(got[0], want[0]),
                                          err(got[1], want[1]))
                checks_ok &= _flag_sample_ok(cols[0], cols[1], got, sample, lanes, flag, leaking)
        # the inactivity penalties past their grid's first chunk a warp, and
        # one validator in (every column off the warp chunks: one a thread)
        pen_cols = (wide["eff"][offset:], wide["scores"][offset:],
                    wide["eligible"][offset:] & ~wide["participating"][offset:])
        got = sweeps.inactivity_penalties(*pen_cols, denominator)
        torch.cuda.synchronize()
        errs["inactivity_penalties"] = max(
            errs["inactivity_penalties"],
            err(got, sweeps.inactivity_penalties_plain(*pen_cols, denominator)))
        print(f"altair_sweeps flag deltas and penalties n={n} (offset {offset}): max_abs_err vs "
              f"plain {errs}, Python sample ok {checks_ok}")
        if any(errs.values()) or not checks_ok:
            sys.exit(f"chip_smoke: the flag-delta or penalty kernel disagrees at n={n}, "
                     f"offset {offset}")
    # B3 past its co-resident grid too (a warp takes several chunks and
    # reads all but its first again), and one validator in (every column
    # unaligned: one validator a thread), the census included
    for offset in (0, 1):
        cols = [wide[k][offset:] for k in ("balances", "eff", "prev_part", "slashed",
                                           "active_prev", "eligible", "scores")]
        census = {}
        for leaking in (False, True):
            got = epoch.fused_epoch(*cols, *_fused_scalars(leaking))
            torch.cuda.synchronize()
            want = epoch.fused_epoch_plain(*cols, *_fused_scalars(leaking))
            errs["fused_epoch"] = max(errs["fused_epoch"], err(got[0], want[0]),
                                      err(got[1], want[1]), abs(got[2] - want[2]))
            census[f"leaking={leaking}"] = (got[2], want[2])
        print(f"altair_sweeps fused epoch n={FLAG_WIDE_N - offset} (offset {offset}): max_abs_err "
              f"vs plain {errs['fused_epoch']}, census (kernel, plain) {census}")
        if errs["fused_epoch"]:
            sys.exit(f"chip_smoke: the fused epoch kernel disagrees at n={FLAG_WIDE_N - offset}")
    del wide, cols

    # the last n checked is the main path's, 2^20
    n = ALTAIR_CHECK_NS[-1]
    part, elig = c["participating"], c["eligible"]
    flag_args = (ALTAIR_TOTAL_ACTIVE, ALTAIR_WEIGHTS[1], ALTAIR_INCREMENT, ALTAIR_BRF,
                 ALTAIR_WD, 0, 0)
    timings = {
        "flag_deltas": _sweep_timing(
            "flag_deltas", lambda: sweeps._launch_flag_deltas(c["eff"], part, elig, flag_args),
            lambda: sweeps.flag_deltas_plain(c["eff"], part, elig, *flag_args[:5], False, False),
            n, n + int((part & elig).sum()) + int((elig & ~part).sum()),
            FLAG_DELTAS_OPS, FLAG_DELTAS_BYTES),
        "inactivity_updates": _sweep_timing(
            "inactivity_updates",
            lambda: sweeps._launch_inactivity_updates(c["scores"], part, elig,
                                                      (ALTAIR_BIAS, ALTAIR_RECOVERY, 0)),
            lambda: sweeps.inactivity_updates_plain(c["scores"], part, elig, ALTAIR_BIAS,
                                                    ALTAIR_RECOVERY, False),
            n, 0, INACTIVITY_UPDATES_OPS, INACTIVITY_UPDATES_BYTES),
        "inactivity_penalties": _sweep_timing(
            "inactivity_penalties",
            lambda: sweeps._launch_inactivity_penalties(c["eff"], c["scores"], not_target,
                                                        denominator),
            lambda: sweeps.inactivity_penalties_plain(c["eff"], c["scores"], not_target,
                                                      denominator),
            n, int(not_target.sum()), INACTIVITY_PENALTIES_OPS, INACTIVITY_PENALTIES_BYTES),
    }
    copy_ms, empty_ms = _yardsticks(n * INACTIVITY_UPDATES_BYTES)
    timings["inactivity_updates"].update(copy_ms=copy_ms, empty_ms=empty_ms)
    print(f"altair_sweeps inactivity_updates n=2^20: a copy of its {INACTIVITY_UPDATES_BYTES} "
          f"bytes a validator {copy_ms:.4f} ms, an empty launch {empty_ms:.4f} ms")
    timings["inactivity_updates"]["ptxas"] = _sweep_ptxas("altair_sweeps",
                                                          "inactivity_updates_kernel")
    scalars = _fused_scalars(False)
    columns = [c[k] for k in ("balances", "eff", "prev_part", "slashed", "active_prev",
                              "eligible", "scores")]
    unslashed = c["active_prev"] & ~c["slashed"]
    fused_divisions = n + int((elig & ~c["participating"]).sum())
    for f in range(3):
        flag_set = unslashed & ((c["prev_part"] >> f) & 1).bool()
        fused_divisions += int((elig & flag_set).sum())
        if f != 2:
            fused_divisions += int((elig & ~flag_set).sum())
    words = epoch._scalars(*scalars)
    timings["fused_epoch"] = _sweep_timing(
        "fused_epoch", lambda: epoch._launch(tuple(columns), words),
        lambda: epoch.fused_epoch_plain(*columns, *scalars),
        n, fused_divisions, FUSED_OPS, FUSED_BYTES)
    # the penalties at a 4-shard share of the registry too
    quarter = _altair_columns(PENALTIES_QUARTER_N, gen)
    quarter_cols = (quarter["eff"], quarter["scores"],
                    quarter["eligible"] & ~quarter["participating"])
    timings["inactivity_penalties"]["ms_quarter"] = _cuda_ms(
        lambda: sweeps._launch_inactivity_penalties(*quarter_cols, denominator), reps=50,
        warmup=5)
    penalties_ptxas = _ptxas_lines("altair_sweeps", "inactivity_penalties_kernel")
    timings["inactivity_penalties"]["ptxas"] = penalties_ptxas
    print(f"altair_sweeps inactivity_penalties n={PENALTIES_QUARTER_N}: "
          f"{timings['inactivity_penalties']['ms_quarter']:.4f} ms; ptxas {penalties_ptxas}; "
          f"SASS instructions "
          f"{_sass_kernel_instructions('altair_sweeps', ('inactivity_penalties_kernel',))}")
    if len(penalties_ptxas) != 1 or any(line.get("spill_stores") or line.get("stack_frame")
                                        for line in penalties_ptxas):
        sys.exit("chip_smoke: ptxas gives the inactivity penalties a frame or spills")
    timings["flag_deltas"]["ptxas"] = _ptxas_lines("altair_sweeps", "flag_deltas_kernel")
    print(f"altair_sweeps: SASS instructions altair_sweeps {_sass_instructions('altair_sweeps')}, "
          f"fused_epoch {_sass_instructions('fused_epoch')}; ptxas flag deltas "
          f"{timings['flag_deltas']['ptxas']}")
    # B3, its apply entries and K3: registers, frame and spills; SASS a kernel
    passes = (_ptxas_lines("fused_epoch", "fused_epoch_kernel")
              + _ptxas_lines("fused_epoch", "apply_kernel") + _ptxas_lines("chain_step",
                                                                            "apply_kernel"))
    timings["fused_epoch"]["ptxas"] = passes
    print(f"altair_sweeps: ptxas of B3, its apply entries and K3 {passes}; SASS instructions "
          f"{_sass_kernel_instructions('fused_epoch', ('fused_epoch_kernel', 'apply_kernel'))} "
          f"{_sass_kernel_instructions('chain_step', ('apply_kernel',))}")
    if len(passes) != 4 or any(line.get("spill_stores") or line.get("stack_frame")
                               for line in passes):
        sys.exit("chip_smoke: ptxas gives B3, an apply entry or K3 a frame or spills")
    return {name: {**t, "max_abs_err": errs[name]} for name, t in timings.items()}


# --- the masked sums: K2 and the B9-epoch flag sums -----------------------

# n of the checks: the main path's registry, a 4-shard share of it, a wide
# registry whose last 5 validators go one a thread, one validator and none;
# then a view one row into 2^20 + 1 rows (every column off the vector path)
SUMS_CHECK_NS = (VALIDATORS, VALIDATORS // 4, (1 << 21) + 5, 1, 0)
SUMS_TIMED_NS = (VALIDATORS, VALIDATORS // 4)


def _sums_columns(n: int, seed: int) -> tuple:
    """Seeded columns on the card: effective balances over the whole u64
    range (every sum wraps past 2^64), flags 0..7, about a tenth slashed and
    nine tenths active in each epoch."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    eff = torch.randint(-(1 << 63), (1 << 63) - 1, (n,), generator=gen, dtype=torch.int64,
                        device="cuda")
    part = torch.randint(0, 8, (n,), generator=gen, dtype=torch.uint8, device="cuda")
    slashed, active_prev, active_cur = (
        torch.rand(n, generator=gen, device="cuda") < p for p in (0.1, 0.9, 0.9))
    return eff, part, slashed, active_prev, active_cur


def phase_sums() -> dict:
    """K2 (epoch_step_sums) and the B9-epoch flag sums (fused_flag_sums),
    csrc/masked_sums.h's kernel at four and three sums, bit-exact against
    their plain versions at SUMS_CHECK_NS and on a view one row in;
    CUDA-event times at 2^20 and 2^18; the timer's floor (an empty launch);
    ptxas' registers, frame and spills of both builds (a frame or a spill
    fails the run)."""
    from ethereum_consensus_tpu_torch.ops import chain_step as cs
    from ethereum_consensus_tpu_torch.ops import epoch

    t0 = time.perf_counter()
    checks, bad = {}, []
    for n in (*SUMS_CHECK_NS, "offset"):
        if n == "offset":
            cols = tuple(c[1:] for c in _sums_columns(VALIDATORS + 1, seed=1))
        else:
            cols = _sums_columns(n, seed=n)
        errs = {"epoch_step_sums": _words_err(cs.epoch_step_sums_cuda(*cols),
                                              cs.epoch_step_sums_plain(*cols)),
                "fused_flag_sums": _words_err(epoch.fused_flag_sums_cuda(*cols[:4]),
                                              epoch.fused_flag_sums_plain(*cols[:4]))}
        checks[str(n)] = errs
        bad += [f"{name} at {n}" for name, err in errs.items() if err]
    print(f"sums: max_abs_err vs plain by n {checks}")
    timed = {}
    for n in SUMS_TIMED_NS:
        cols = _sums_columns(n, seed=n)
        timed[n] = {"epoch_step_sums": _cuda_ms(lambda: cs._launch_sums(cols), reps=50,
                                                warmup=5),
                    "fused_flag_sums": _cuda_ms(lambda: epoch.fused_flag_sums_cuda(*cols[:4]),
                                                reps=50, warmup=5)}
        print(f"sums n={n}: ms {_rounded(timed[n], 4)} (bounds by bytes "
              f"{1e3 * n * EPOCH_SUMS_BYTES / MEM_BYTES_PER_S:.4f} and "
              f"{1e3 * n * FLAG_SUMS_BYTES / MEM_BYTES_PER_S:.4f} ms)")
    floor = _cuda_ms(lambda: torch.cuda._sleep(0), reps=50, warmup=5)
    print(f"sums: the timer's floor (an empty launch) {floor:.4f} ms")
    ptxas = (_ptxas_lines("chain_step", "masked_sums_kernel")
             + _ptxas_lines("fused_epoch", "masked_sums_kernel"))
    print(f"sums: ptxas of K2 and the flag sums {ptxas}; SASS instructions "
          f"{_sass_kernel_instructions('chain_step', ('masked_sums_kernel',))} "
          f"{_sass_kernel_instructions('fused_epoch', ('masked_sums_kernel',))}")
    if bad:
        sys.exit(f"chip_smoke: the masked sums disagree with their plain versions: {bad}")
    if len(ptxas) != 2 or any(line.get("spill_stores") or line.get("stack_frame")
                              for line in ptxas):
        sys.exit("chip_smoke: ptxas gives K2 or the flag sums a frame or spills")
    print(f"sums phase: {time.perf_counter() - t0:.1f} s")
    return {"checks": checks, "ms": timed, "timer_floor_ms": floor, "ptxas": ptxas}


# --- the altair block across an altair epoch boundary ---------------------

ALTAIR_FORK_EPOCH = 1  # as tests/chain_utils.py:719 sets it
ALTAIR_PRE_SLOT = 95  # the last slot of epoch 2
ALTAIR_BLOCK_SLOT = 96  # the first slot of epoch 3: the block crosses the boundary
# The capella cell: bellatrix and capella both from epoch 2, so the altair
# state at slot 64 upgrades twice and runs capella's rules to slot 95. One
# validator in CAPELLA_ETH1_SHARE withdraws to an execution address, and the
# sweep starts CAPELLA_SWEEP_BACK validators before the registry's end, so a
# full payload of withdrawals takes it past the end; the block also changes
# CAPELLA_BLS_CHANGES validators' credentials (mainnet's
# MAX_BLS_TO_EXECUTION_CHANGES). The tampered block changes one withdrawal.
CAPELLA_FORK_EPOCH = 2
CAPELLA_ETH1_SHARE = 512
CAPELLA_SWEEP_BACK = 4096
CAPELLA_BLS_CHANGES = 16
CAPELLA_TAMPERED_WITHDRAWAL = 5
# The deneb cell: deneb from epoch 2 too, so the capella cell's state at the
# fork slot 64 upgrades once more and runs deneb's rules to slot 95; the
# altair scramble under a seed of its own queues 128 eligible entrants, of
# which EIP-7514 activates min(max_per_epoch_activation_churn_limit, churn
# limit). The block carries DENEB_BLOBS blob commitments (mainnet's
# MAX_BLOBS_PER_BLOCK) besides the capella block's withdrawals and changes,
# the tampered block one more. The data-availability check is also run with
# one field element of one blob changed, and with one node of one sidecar's
# inclusion proof changed: (blob or sidecar, element or node).
DENEB_BLOBS = 6
DENEB_GAS_PER_BLOB = 1 << 17  # EIP-4844's GAS_PER_BLOB
DENEB_CHANGED_ELEMENT = (2, 100)
DENEB_CHANGED_NODE = (4, 3)
# The electra cell: electra from epoch 2 as well, so the deneb cell's state at
# the fork slot 64 upgrades once more and runs electra's rules to slot 95;
# the altair scramble under a seed of its own (its eligible entrants all
# activate, its ejections exit under the balance-weighted churn), then the
# EIP-7251 work of bench.py:1308-1329: ELECTRA_PENDING_DEPOSITS pending
# deposits of 1 ETH (the boundary takes the activation-exit churn's worth),
# ELECTRA_CONSOLIDATIONS ripe pending consolidations onto 0x01 targets, one
# with a slashed source before them and one with an unripe source after
# them (which stops the stage, with one more ripe one behind it), one
# validator in ELECTRA_COMPOUNDING_SHARE on 0x02 credentials with 33 to
# 2,100 ETH, and ELECTRA_PARTIALS pending partial withdrawals of such
# validators. The block at slot 96 carries two committee-spanning
# aggregates (EIP-7549), of slots ELECTRA_ATTESTED_SLOTS, besides deneb's
# commitments and capella's changes; its payload the expected withdrawals
# (MAX_PENDING_PARTIALS_PER_WITHDRAWALS_SWEEP from the partials, the rest
# from the sweep), ELECTRA_RECEIPTS deposit receipts (top-ups, then one new
# validator) and ELECTRA_REQUESTS withdrawal requests from 0x01 addresses,
# no-ops under shard_committee_period at epoch 3; and one consolidation
# between two 0x01 validators of one address. The tampered block's
# consolidation is signed by the source's key alone.
ELECTRA_PENDING_DEPOSITS = 1024
ELECTRA_CONSOLIDATIONS = 64
ELECTRA_COMPOUNDING_SHARE = 512
ELECTRA_PARTIALS = 16
ELECTRA_RECEIPTS = 16
ELECTRA_REQUESTS = 16
ELECTRA_ATTESTED_SLOTS = (94, 95)


def _public_keys(indices) -> dict:
    """index -> the compressed key of SecretKey(index + 1), ascending by
    index: the native library walks the keys by additions of the
    generator (native/bls.py small_sk_to_pk_batch), about one addition a
    key where sk_to_pk pays a 255-bit multiplication and an inversion."""
    from ethereum_consensus_tpu_torch.native import bls as native_bls

    order = sorted(set(indices))
    return dict(zip(order, native_bls.small_sk_to_pk_batch([i + 1 for i in order])))


def _realize_keys(state, indices, known: "dict | None" = None) -> int:
    """Give ``indices`` their real keys SecretKey(i + 1), taken from
    ``known`` (index -> key bytes) where it holds them and added to it;
    returns how many."""
    indices = set(indices)
    known = {} if known is None else known
    known.update(_public_keys(i for i in indices if i not in known))
    for i in indices:
        state.validators[i].public_key = known[i]
    state.__dict__.pop("_pubkey_index_cache", None)
    return len(indices)


def scramble_altair(state, ctx, seed: int) -> dict:
    """Registry churn for the boundary into epoch 3 of an altair state at
    slot 95, leaving every active set up to epoch 2 as it was: hysteresis
    crossings both ways, ejections, slashed validators at the penalty
    halfway point, future exits, low balances a penalty saturates, nonzero
    inactivity scores, appended entrants, and the participation flags of
    epochs 1 and 2 with a seeded share of missed target and head flags."""
    from ethereum_consensus_tpu_torch.models.phase0 import build
    from ethereum_consensus_tpu_torch.primitives import FAR_FUTURE_EPOCH

    ns = build(ctx.preset)
    rng = np.random.default_rng(seed)
    n = len(state.validators)
    inc = int(ctx.EFFECTIVE_BALANCE_INCREMENT)
    down, up = inc // 4, 5 * inc // 4
    picks = rng.choice(n, 3488, replace=False).tolist()
    downs, ups, ejects, slashed, exits, lows = (
        picks[:1536], picks[1536:3072], picks[3072:3104], picks[3104:3168],
        picks[3168:3232], picks[3232:3488])
    for i in downs:
        state.balances[i] = int(state.balances[i]) - down - inc // 10
    for i in ups:
        state.validators[i].effective_balance = 20 * inc
        state.balances[i] = 20 * inc + up + inc // 10
    for i in ejects:
        state.validators[i].effective_balance = int(ctx.ejection_balance)
    half = int(ctx.EPOCHS_PER_SLASHINGS_VECTOR) // 2
    for i in slashed:
        state.validators[i].slashed = True
        state.validators[i].withdrawable_epoch = 2 + half
    state.slashings[2] = 64 * int(ctx.MAX_EFFECTIVE_BALANCE)
    for i in exits:
        state.validators[i].exit_epoch = 10
        state.validators[i].withdrawable_epoch = 10 + int(ctx.min_validator_withdrawability_delay)
    for i in lows:
        state.balances[i] = int(rng.integers(0, 10**6))
    scores = np.zeros(n, dtype=np.uint64)
    scored = rng.random(n) < 0.125
    scores[scored] = rng.integers(1, 5000, int(scored.sum()), dtype=np.uint64)
    scores[rng.choice(n, 64, replace=False)] = 10**6
    participation = []
    for _epoch in (1, 2):
        flags = np.full(n, 0b111, dtype=np.uint8)
        r = rng.random(n)
        flags[r < 0.10] = 0b001  # source only: target and head missed
        flags[(r >= 0.10) & (r < 0.15)] = 0b011  # head missed
        flags[(r >= 0.15) & (r < 0.18)] = 0
        participation.append(flags)
    state.previous_epoch_participation = participation[0].tolist()
    state.current_epoch_participation = participation[1].tolist()
    state.inactivity_scores = scores.tolist()
    for k in range(256):
        state.validators.append(ns.Validator(
            public_key=_synthetic_pubkey(n + k),
            withdrawal_credentials=b"\x00" * 32,
            effective_balance=int(ctx.MAX_EFFECTIVE_BALANCE),
            activation_eligibility_epoch=FAR_FUTURE_EPOCH if k % 2 else 0,
            activation_epoch=FAR_FUTURE_EPOCH,
            exit_epoch=FAR_FUTURE_EPOCH,
            withdrawable_epoch=FAR_FUTURE_EPOCH,
        ))
        state.balances.append(int(ctx.MAX_EFFECTIVE_BALANCE))
        state.previous_epoch_participation.append(0)
        state.current_epoch_participation.append(0)
        state.inactivity_scores.append(0)
    for key in ("_active_idx_cache", "_proposer_cache", "_total_active_balance_cache",
                "_pubkey_index_cache"):
        state.__dict__.pop(key, None)
    missed = [int(((p >> 1) & 1 == 0).sum()) for p in participation]
    return {"downward": len(downs), "upward": len(ups), "ejections": len(ejects),
            "slashed": len(slashed), "exits": len(exits), "low_balances": len(lows),
            "scored": int((scores > 0).sum()), "target_missed": missed, "entrants": 256}


def _altair_block(scratch, ctx, slot: int, attestations: list, fork=None, **body):
    """A block of ``fork`` (a models package of the altair family, altair by
    default) at ``slot`` on ``scratch`` (a state processed to ``slot``, the
    proposer's and the sync committee's keys real) carrying
    ``attestations``, a full sync aggregate over the previous slot's block
    root (one signature under the sum of the members' secret keys,
    duplicates counted: the same point as aggregating their signatures) and
    ``body``'s further fields. Runs process_block on ``scratch`` for the
    state root. Returns the block and ``signed(message)``, which signs a
    message as the proposer."""
    from ethereum_consensus_tpu_torch.crypto import bls
    from ethereum_consensus_tpu_torch.crypto.fields import R
    from ethereum_consensus_tpu_torch.domains import DomainType
    from ethereum_consensus_tpu_torch.models import altair
    from ethereum_consensus_tpu_torch.models.phase0.containers import BeaconBlockHeader
    from ethereum_consensus_tpu_torch.primitives import Root
    from ethereum_consensus_tpu_torch.signing import compute_signing_root
    from ethereum_consensus_tpu_torch.ssz import uint64

    fork = fork or altair
    ns, h, block_processing = fork.build(ctx.preset), fork.helpers, fork.block_processing
    proposer = h.get_beacon_proposer_index(scratch, ctx)
    epoch = slot // int(ctx.SLOTS_PER_EPOCH)
    previous = slot - 1
    by_key = {bytes(v.public_key): i for i, v in enumerate(scratch.validators)}
    members = [by_key[bytes(pk)] for pk in scratch.current_sync_committee.public_keys]
    sync_domain = h.get_domain(scratch, DomainType.SYNC_COMMITTEE,
                               previous // int(ctx.SLOTS_PER_EPOCH), ctx)
    sync_root = compute_signing_root(Root, h.get_block_root_at_slot(scratch, previous),
                                     sync_domain)
    sync_aggregate = ns.SyncAggregate(
        sync_committee_bits=[True] * len(members),
        sync_committee_signature=bls.SecretKey(sum(i + 1 for i in members) % R)
        .sign(sync_root).to_bytes(),
    )
    proposer_key = bls.SecretKey(proposer + 1)
    randao_root = compute_signing_root(
        uint64, epoch, h.get_domain(scratch, DomainType.RANDAO, epoch, ctx))
    block = ns.BeaconBlock(
        slot=slot, proposer_index=proposer,
        parent_root=BeaconBlockHeader.hash_tree_root(scratch.latest_block_header),
        body=ns.BeaconBlockBody(
            randao_reveal=proposer_key.sign(randao_root).to_bytes(),
            eth1_data=scratch.eth1_data.copy(), attestations=attestations,
            sync_aggregate=sync_aggregate, **body,
        ),
    )
    block_processing.process_block(scratch, block, ctx)
    block.state_root = type(scratch).hash_tree_root(scratch)
    proposer_domain = h.get_domain(scratch, DomainType.BEACON_PROPOSER, None, ctx)

    def signed(message):
        root = compute_signing_root(ns.BeaconBlock, message, proposer_domain)
        return ns.SignedBeaconBlock(message=message,
                                    signature=proposer_key.sign(root).to_bytes())

    return block, signed


def _aggregate(ns, data, committee: list, domain) -> object:
    """A full aggregate of ``committee`` over ``data``: one signature under
    the sum of the members' secret keys SecretKey(i + 1)."""
    from ethereum_consensus_tpu_torch.crypto import bls
    from ethereum_consensus_tpu_torch.crypto.fields import R
    from ethereum_consensus_tpu_torch.signing import compute_signing_root

    root = compute_signing_root(ns.AttestationData, data, domain)
    return ns.Attestation(
        aggregation_bits=[True] * len(committee), data=data,
        signature=bls.SecretKey(sum(i + 1 for i in committee) % R).sign(root).to_bytes(),
    )


def _cross_for_block(state, ctx, fork, known: dict):
    """``state`` (at slot 95) crossed once, on a scratch copy, to
    ALTAIR_BLOCK_SLOT for the block built there. The slot-96 proposer
    depends on the post-boundary effective balances, not on keys, so it is
    read off the crossing; its key is then made real on both states and the
    one root of the pre-state that the crossing recorded (slot 95's state
    root) is taken again: no later root of the boundary reads a key, so the
    scratch is then what a crossing with the real key gives. The pre-state's
    root is taken before the copy, which carries it: the crossing's first
    slot and the root taken again after the key change then rehash only
    what changed. Returns the scratch and the proposer."""
    type(state).hash_tree_root(state)
    scratch = state.copy()
    fork.slot_processing.process_slots(scratch, ALTAIR_BLOCK_SLOT, ctx)
    proposer = fork.helpers.get_beacon_proposer_index(scratch, ctx)
    if state.validators[proposer].slashed:
        sys.exit("chip_smoke: the scramble slashed the slot-96 proposer")
    for s in (state, scratch):
        _realize_keys(s, [proposer], known)
    limit = len(scratch.state_roots)
    scratch.state_roots[(ALTAIR_BLOCK_SLOT - 1) % limit] = type(state).hash_tree_root(state)
    return scratch, proposer


def make_altair_block(scratch, ctx, committees: list, fork=None, **body):
    """A signed block at ALTAIR_BLOCK_SLOT on ``scratch`` (a state crossed to
    that slot, the committees' and the proposer's keys real) carrying one
    aggregate per slot-95 committee, a full sync aggregate over slot 95's
    block root and ``body``'s further fields. The state root comes from a
    host run on ``scratch``, which verifies every signature inline. Returns
    the block and ``signed(message)``."""
    from ethereum_consensus_tpu_torch.domains import DomainType
    from ethereum_consensus_tpu_torch.models import altair

    fork = fork or altair
    ns, h = fork.build(ctx.preset), fork.helpers
    epoch = ALTAIR_BLOCK_SLOT // int(ctx.SLOTS_PER_EPOCH)
    att_slot = ALTAIR_BLOCK_SLOT - 1
    head_root = h.get_block_root_at_slot(scratch, att_slot)
    target = ns.Checkpoint(epoch=epoch - 1, root=h.get_block_root(scratch, epoch - 1, ctx))
    attester_domain = h.get_domain(scratch, DomainType.BEACON_ATTESTER, epoch - 1, ctx)
    attestations = [
        _aggregate(ns, ns.AttestationData(slot=att_slot, index=index, beacon_block_root=head_root,
                                          source=scratch.previous_justified_checkpoint.copy(),
                                          target=target.copy()),
                   committee, attester_domain)
        for index, committee in enumerate(committees)]
    return _altair_block(scratch, ctx, ALTAIR_BLOCK_SLOT, attestations, fork, **body)


def _committees_at_pre_slot(state, ctx, fork) -> list:
    """Slot 95's beacon committees."""
    h = fork.helpers
    per_slot = h.get_committee_count_per_slot(state, ALTAIR_PRE_SLOT // int(ctx.SLOTS_PER_EPOCH),
                                              ctx)
    return [h.get_beacon_committee(state, ALTAIR_PRE_SLOT, index, ctx)
            for index in range(per_slot)]


# a validator's SSZ record: 121 bytes, its fields in the container's order
VALIDATOR_RECORD = np.dtype([
    ("public_key", "V48"), ("withdrawal_credentials", "u1", (32,)),
    ("effective_balance", "<u8"), ("slashed", "u1"), ("activation_eligibility_epoch", "<u8"),
    ("activation_epoch", "<u8"), ("exit_epoch", "<u8"), ("withdrawable_epoch", "<u8")])


def _serialized_columns(data: bytes, state_type) -> tuple:
    """(validator records, balances, inactivity scores) of a state's SSZ
    bytes, as numpy views of each list's span: from its offset in the fixed
    part to the next variable field's offset. What is read is what was
    serialized, not the port's registry column caches."""
    offsets, at = {}, 0
    for name, field in state_type.fields().items():
        if field.is_fixed_size():
            at += field.fixed_size()
        else:
            offsets[name] = int.from_bytes(data[at:at + 4], "little")
            at += 4
    names = list(offsets)
    ends = dict(zip(names, [offsets[k] for k in names[1:]] + [len(data)]))

    def view(name: str, dtype) -> np.ndarray:
        dtype = np.dtype(dtype)
        count, rest = divmod(ends[name] - offsets[name], dtype.itemsize)
        if rest:
            sys.exit(f"chip_smoke: the state's {name} span is not whole records")
        return np.frombuffer(data, dtype, count, offsets[name])

    return (view("validators", VALIDATOR_RECORD), view("balances", "<u8"),
            view("inactivity_scores", "<u8"))


def _registry_before(pre: bytes, state_type) -> dict:
    """The columns the boundary changes, to count its changes by, and the
    validators not yet activated with their eligibility epochs, read from
    the pre-state's bytes."""
    from ethereum_consensus_tpu_torch.primitives import FAR_FUTURE_EPOCH

    records, balances, scores = _serialized_columns(pre, state_type)
    pending = np.nonzero(records["activation_epoch"] == np.uint64(FAR_FUTURE_EPOCH))[0]
    eligibility = dict(zip(pending.tolist(),
                           records["activation_eligibility_epoch"][pending].tolist()))
    return {"balances": balances, "scores": scores,
            "effective": records["effective_balance"],
            "pending": list(eligibility), "eligibility": eligibility}


def build_altair_pre_state(registry: dict) -> dict:
    """The registry to slot 32 under phase0 rules, the sync committee's keys
    made real and the upgrade to altair, slots to 64 under altair rules
    (the 63 -> 64 boundary on the host route), where the capella, deneb and
    electra cells' set-ups upgrade it (``build_capella_pre_state``,
    ``build_deneb_pre_state``, ``build_electra_pre_state``); then slots to
    95, the scramble, the keys of slot 95's committees and of the slot-96
    proposer made real, and the block, built on the one crossing. Returns
    the pre-state's bytes, the block, the tampered copy and the crossed
    scratch's bytes, and the capella, deneb and electra cells'."""
    from ethereum_consensus_tpu_torch import ops
    from ethereum_consensus_tpu_torch.config import Context
    from ethereum_consensus_tpu_torch.models import altair
    from ethereum_consensus_tpu_torch.models.altair import helpers as ah
    from ethereum_consensus_tpu_torch.models.altair import slot_processing as aslots
    from ethereum_consensus_tpu_torch.models.altair import upgrade_to_altair
    from ethereum_consensus_tpu_torch.models.phase0 import slot_processing as pslots

    ops.uninstall()
    ctx = Context.for_mainnet()
    ctx.altair_fork_epoch = ALTAIR_FORK_EPOCH
    fork_slot = ALTAIR_FORK_EPOCH * int(ctx.SLOTS_PER_EPOCH)
    t0 = time.perf_counter()
    phase0_state = _setup_state(registry)
    pslots.process_slots(phase0_state, fork_slot, ctx)
    to_fork_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    known: dict = {}
    sync_keys = _realize_keys(phase0_state, ah.get_next_sync_committee_indices(phase0_state, ctx),
                              known)
    state = upgrade_to_altair(phase0_state, ctx)
    del phase0_state
    upgrade_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    aslots.process_slots(state, CAPELLA_FORK_EPOCH * int(ctx.SLOTS_PER_EPOCH), ctx)
    to_capella_fork_s = time.perf_counter() - t0
    # the upgrades copy every field, so the altair state goes on as it was,
    # the capella state at the fork slot as the deneb cell's starts and the
    # deneb state there as the electra cell's
    capella_fork = _capella_at_fork(state)
    deneb_fork = _deneb_at_fork(capella_fork[0])
    electra_fork = _electra_at_fork(deneb_fork[0])
    capella = build_capella_pre_state(*capella_fork, known)
    del capella_fork
    deneb = build_deneb_pre_state(*deneb_fork, known)
    del deneb_fork
    electra = build_electra_pre_state(*electra_fork, known, deneb["commitments"])
    electra["post_check"] = _electra_checks
    del electra_fork
    t0 = time.perf_counter()
    aslots.process_slots(state, ALTAIR_PRE_SLOT, ctx)
    to_pre_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scrambled = scramble_altair(state, ctx, seed=4)
    committees = _committees_at_pre_slot(state, ctx, altair)
    committee_keys = _realize_keys(state, [i for c in committees for i in c], known)
    scramble_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scratch, proposer = _cross_for_block(state, ctx, altair, known)
    reject_pre = type(scratch).serialize(scratch)
    block, signed = make_altair_block(scratch, ctx, committees)
    del scratch
    good = signed(block)
    tampered = block.copy()
    tampered.body.sync_aggregate.sync_committee_signature = bytes(good.signature)
    tampered = signed(tampered)
    block_s = time.perf_counter() - t0
    n = len(state.validators)
    t0 = time.perf_counter()
    pre = type(state).serialize(state)
    serialize_s = time.perf_counter() - t0
    before = _registry_before(pre, type(state))
    del state
    print(f"altair: {n} validators; slots 0..{fork_slot} {to_fork_s:.1f} s; {sync_keys} sync "
          f"committee keys and the upgrade {upgrade_s:.1f} s; slots to "
          f"{CAPELLA_FORK_EPOCH * int(ctx.SLOTS_PER_EPOCH)} {to_capella_fork_s:.1f} s and on to "
          f"{ALTAIR_PRE_SLOT} {to_pre_s:.1f} s; scramble {scrambled} and {committee_keys} "
          f"committee keys {scramble_s:.1f} s; one scratch crossing, its bytes and the block "
          f"{block_s:.1f} s; serialize ({len(pre)} bytes) {serialize_s:.1f} s")
    return {"pre": pre, "ctx": ctx, "good": good, "tampered": tampered, "reject_pre": reject_pre,
            "n": n, "before": before, "scrambled": scrambled, "proposer": proposer,
            "capella": capella, "deneb": deneb, "electra": electra,
            "setup_s": {"to_fork": to_fork_s, "upgrade": upgrade_s,
                        "to_capella_fork": to_capella_fork_s, "to_pre": to_pre_s,
                        "scramble_and_keys": scramble_s, "block": block_s,
                        "serialize": serialize_s}}


def _withdrawal_address(index: int) -> bytes:
    return hashlib.sha256(b"execution-address" + index.to_bytes(8, "little")).digest()[:20]


def _capella_credentials(state, ctx, rng) -> tuple:
    """A seeded share of validators (one in CAPELLA_ETH1_SHARE) turned to
    0x01 credentials with a balance above 32 ETH: partial withdrawals,
    sparse enough that the sweep from its cursor, CAPELLA_SWEEP_BACK before
    the registry's end, walks past the end to find MAX_WITHDRAWALS_PER_PAYLOAD
    of them; and CAPELLA_BLS_CHANGES unslashed 0x00 validators whose
    credentials are pointed at withdrawal keys the set-up makes. Returns
    (the 0x01 indices, [(index, withdrawal key)])."""
    from ethereum_consensus_tpu_torch.crypto import bls
    from ethereum_consensus_tpu_torch.crypto.fields import R

    n = len(state.validators)
    picks = rng.permutation(n).tolist()
    eth1 = picks[:n // CAPELLA_ETH1_SHARE]
    cap = int(ctx.MAX_EFFECTIVE_BALANCE)
    for i in eth1:
        state.validators[i].withdrawal_credentials = (b"\x01" + b"\x00" * 11
                                                      + _withdrawal_address(i))
        state.balances[i] = cap + int(rng.integers(10**8, 2 * 10**9))
    changes = []
    for i in picks[n // CAPELLA_ETH1_SHARE:]:
        if len(changes) == CAPELLA_BLS_CHANGES:
            break
        if state.validators[i].slashed:
            continue
        seed = hashlib.sha256(b"withdrawal-key" + i.to_bytes(8, "little")).digest()
        key = bls.SecretKey(int.from_bytes(seed, "big") % (R - 1) + 1)
        state.validators[i].withdrawal_credentials = (
            b"\x00" + hashlib.sha256(key.public_key().to_bytes()).digest()[1:])
        changes.append((i, key))
    state.next_withdrawal_validator_index = n - CAPELLA_SWEEP_BACK
    return eth1, changes


def _bls_changes(state, ctx, changes: list) -> list:
    """Each (index, withdrawal key) of ``changes`` as a signed change of the
    validator's credentials to an execution address."""
    from ethereum_consensus_tpu_torch.domains import DomainType
    from ethereum_consensus_tpu_torch.models import capella
    from ethereum_consensus_tpu_torch.signing import compute_signing_root

    ns = capella.build(ctx.preset)
    domain = capella.helpers.compute_domain(DomainType.BLS_TO_EXECUTION_CHANGE, None,
                                            bytes(state.genesis_validators_root), ctx)
    out = []
    for index, key in changes:
        message = ns.BlsToExecutionChange(validator_index=index,
                                          from_bls_public_key=key.public_key().to_bytes(),
                                          to_execution_address=_withdrawal_address(index))
        root = compute_signing_root(ns.BlsToExecutionChange, message, domain)
        out.append(ns.SignedBlsToExecutionChange(message=message,
                                                 signature=key.sign(root).to_bytes()))
    return out


def _forked_ctx(*forks: str):
    """Mainnet's context with altair at epoch 1 and each of ``forks`` at
    epoch 2."""
    from ethereum_consensus_tpu_torch.config import Context

    ctx = Context.for_mainnet()
    ctx.altair_fork_epoch = ALTAIR_FORK_EPOCH
    for fork in forks:
        setattr(ctx, f"{fork}_fork_epoch", CAPELLA_FORK_EPOCH)
    return ctx


def _capella_at_fork(state) -> tuple:
    """The altair set-up's ``state`` at the fork slot 64 upgraded to
    bellatrix and to capella (both at epoch 2), with the payload header of a
    post-merge chain. Returns (the capella state, its context, seconds)."""
    from ethereum_consensus_tpu_torch.models import capella
    from ethereum_consensus_tpu_torch.models.bellatrix import upgrade_to_bellatrix

    t0 = time.perf_counter()
    ctx = _forked_ctx("bellatrix", "capella")
    state = capella.upgrade_to_capella(upgrade_to_bellatrix(state, ctx), ctx)
    ns = capella.build(ctx.preset)
    last_slot = CAPELLA_FORK_EPOCH * int(ctx.SLOTS_PER_EPOCH) - 1
    state.latest_execution_payload_header = ns.ExecutionPayloadHeader(
        parent_hash=hashlib.sha256(b"execution-block-%d" % (last_slot - 1)).digest(),
        block_hash=hashlib.sha256(b"execution-block-%d" % last_slot).digest(),
        block_number=last_slot, gas_limit=30_000_000, gas_used=15_000_000,
        timestamp=capella.helpers.compute_timestamp_at_slot(state, last_slot, ctx),
        base_fee_per_gas=7)
    return state, ctx, time.perf_counter() - t0


def _deneb_at_fork(capella_state) -> tuple:
    """The capella state at the fork slot upgraded to deneb (bellatrix,
    capella and deneb all at epoch 2, a network that forks three times at
    once): a copy. Returns (the deneb state, its context, seconds)."""
    from ethereum_consensus_tpu_torch.models import deneb

    t0 = time.perf_counter()
    ctx = _forked_ctx("bellatrix", "capella", "deneb")
    state = deneb.upgrade_to_deneb(capella_state, ctx)
    return state, ctx, time.perf_counter() - t0


def _payload(fork, scratch, ctx, proposer: int, withdrawals: list, **fields):
    """The slot-96 execution payload of ``fork`` on the crossed ``scratch``:
    its parent the latest header's block, ``prev_randao`` and the timestamp
    as the state expects, the expected ``withdrawals`` and ``fields``."""
    ns, h = fork.build(ctx.preset), fork.helpers
    header = scratch.latest_execution_payload_header
    return ns.ExecutionPayload(
        parent_hash=header.block_hash, fee_recipient=_withdrawal_address(proposer),
        state_root=hashlib.sha256(b"execution-state-%d" % ALTAIR_BLOCK_SLOT).digest(),
        receipts_root=hashlib.sha256(b"execution-receipts-%d" % ALTAIR_BLOCK_SLOT).digest(),
        prev_randao=h.get_randao_mix(scratch, ALTAIR_BLOCK_SLOT // int(ctx.SLOTS_PER_EPOCH)),
        block_number=header.block_number + 1, gas_limit=header.gas_limit, gas_used=14_000_000,
        timestamp=h.compute_timestamp_at_slot(scratch, ALTAIR_BLOCK_SLOT, ctx),
        base_fee_per_gas=header.base_fee_per_gas,
        block_hash=hashlib.sha256(b"execution-block-%d" % ALTAIR_BLOCK_SLOT).digest(),
        withdrawals=withdrawals, **fields)


def _full_sweep(cell: str, scratch, state, ctx) -> list:
    """The crossed ``scratch``'s expected withdrawals, which must be a full
    payload that wrapped past the registry's end."""
    from ethereum_consensus_tpu_torch.models import capella

    withdrawals = capella.block_processing.get_expected_withdrawals(scratch, ctx)
    if len(withdrawals) != int(ctx.MAX_WITHDRAWALS_PER_PAYLOAD) or \
            withdrawals[-1].validator_index >= state.next_withdrawal_validator_index:
        sys.exit(f"chip_smoke: the {cell} sweep found {len(withdrawals)} withdrawals, not a "
                 "full payload past the registry's end")
    return withdrawals


def build_capella_pre_state(state, ctx, upgrade_s: float, known: dict) -> dict:
    """The capella cell's pre-state from ``state`` (``_capella_at_fork``'s,
    at the fork slot 64): slots to 95 under capella rules, the altair cell's
    scramble under another seed, the credentials of
    ``_capella_credentials``, the keys of slot 95's committees and of the
    slot-96 proposer made real (kept in ``known``, which the other cells'
    set-ups go on with), and a signed capella block at slot 96 with the
    expected withdrawals, 64 aggregates, a full sync aggregate and the
    changes. Returns the pre-state's bytes, the block, a copy with one
    withdrawal changed, re-signed, and the bytes of the crossed scratch state
    the block was built on."""
    from ethereum_consensus_tpu_torch.models import capella

    t0 = time.perf_counter()
    capella.slot_processing.process_slots(state, ALTAIR_PRE_SLOT, ctx)
    to_pre_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scrambled = scramble_altair(state, ctx, seed=5)
    eth1, changes = _capella_credentials(state, ctx, np.random.default_rng(7))
    committees = _committees_at_pre_slot(state, ctx, capella)
    committee_keys = _realize_keys(state, [i for c in committees for i in c], known)
    scramble_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scratch, proposer = _cross_for_block(state, ctx, capella, known)
    reject_pre = type(scratch).serialize(scratch)
    withdrawals = _full_sweep("capella", scratch, state, ctx)
    payload = _payload(capella, scratch, ctx, proposer, withdrawals)
    block, signed = make_altair_block(scratch, ctx, committees, capella, execution_payload=payload,
                                      bls_to_execution_changes=_bls_changes(state, ctx, changes))
    del scratch
    tampered = block.copy()
    tampered.body.execution_payload.withdrawals[CAPELLA_TAMPERED_WITHDRAWAL].amount += 1
    block_s = time.perf_counter() - t0
    n = len(state.validators)
    t0 = time.perf_counter()
    pre = type(state).serialize(state)
    serialize_s = time.perf_counter() - t0
    before = _registry_before(pre, type(state))
    del state
    sweep = [int(w.validator_index) for w in withdrawals]
    print(f"capella: {n} validators; upgrades at slot "
          f"{CAPELLA_FORK_EPOCH * int(ctx.SLOTS_PER_EPOCH)} {upgrade_s:.1f} "
          f"s; slots to {ALTAIR_PRE_SLOT} {to_pre_s:.1f} s; scramble {scrambled}, {len(eth1)} "
          f"0x01 validators, {len(changes)} withdrawal keys and {committee_keys} committee keys "
          f"{scramble_s:.1f} s; one scratch crossing, its bytes and the block {block_s:.1f} s (withdrawals "
          f"of validators {sweep[0]}..{sweep[-1]}, sweep from {n - CAPELLA_SWEEP_BACK}); "
          f"serialize ({len(pre)} bytes) {serialize_s:.1f} s")
    return {"pre": pre, "ctx": ctx, "good": signed(block), "tampered": signed(tampered),
            "reject_pre": reject_pre, "n": n, "before": before, "scrambled": scrambled,
            "proposer": proposer, "withdrawals": sweep, "changes": [i for i, _ in changes],
            "setup_s": {"upgrades": upgrade_s, "to_pre": to_pre_s,
                        "scramble_and_keys": scramble_s, "block": block_s,
                        "serialize": serialize_s}}


def _blob(seed: int, elements: int) -> bytes:
    """A seeded blob: ``elements`` canonical field elements (31 random bytes
    under a zero byte each)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 256, (elements, 32), dtype=np.uint8)
    words[:, 0] = 0
    return words.tobytes()


def _blob_sidecars(signed_block, blobs: list, ctx) -> list:
    """The block's blob sidecars: each blob with its commitment, its KZG
    proof on ``ctx.kzg_settings``, the signed block header and the
    commitment's inclusion proof in the block body."""
    from ethereum_consensus_tpu_torch.crypto import kzg
    from ethereum_consensus_tpu_torch.models import deneb
    from ethereum_consensus_tpu_torch.models.phase0.containers import (
        BeaconBlockHeader,
        SignedBeaconBlockHeader,
    )
    from ethereum_consensus_tpu_torch.ssz import get_generalized_index, prove

    ns = deneb.build(ctx.preset)
    block = signed_block.message
    body = block.body
    header = SignedBeaconBlockHeader(
        message=BeaconBlockHeader(slot=block.slot, proposer_index=block.proposer_index,
                                  parent_root=block.parent_root, state_root=block.state_root,
                                  body_root=ns.BeaconBlockBody.hash_tree_root(body)),
        signature=signed_block.signature)
    sidecars = []
    for index, (blob, commitment) in enumerate(zip(blobs, body.blob_kzg_commitments)):
        gindex = get_generalized_index(ns.BeaconBlockBody, "blob_kzg_commitments", index)
        sidecars.append(ns.BlobSidecar(
            index=index, blob=blob, kzg_commitment=commitment,
            kzg_proof=kzg.compute_blob_kzg_proof(blob, bytes(commitment), ctx.kzg_settings),
            signed_block_header=header.copy(),
            kzg_commitment_inclusion_proof=prove(ns.BeaconBlockBody, body, gindex)))
    return sidecars


def build_deneb_pre_state(state, ctx, upgrade_s: float, known: dict) -> dict:
    """The deneb cell's pre-state from ``state`` (``_deneb_at_fork``'s, at the
    fork slot 64): slots to 95 under deneb rules, the altair cell's scramble
    under a seed of its own (its 128 eligible entrants queue for
    activation), the capella cell's credentials and keys (``known``), six
    seeded blobs committed on the in-repo ceremony (``ctx.kzg_settings``),
    and a signed deneb block at slot 96 with the six commitments, a payload
    with the expected withdrawals and the blob gas of six blobs, 64
    aggregates, a full sync aggregate and the changes; then its six blob
    sidecars. The crossed scratch state the block was built on is kept as
    bytes: the block with a seventh commitment is refused there. Returns
    the pre-state's bytes, the block, the tampered copy, the scratch's
    bytes, the sidecars and the activation cap and churn limit of the
    pre-state."""
    from ethereum_consensus_tpu_torch.crypto import kzg
    from ethereum_consensus_tpu_torch.models import deneb

    t0 = time.perf_counter()
    deneb.slot_processing.process_slots(state, ALTAIR_PRE_SLOT, ctx)
    to_pre_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scrambled = scramble_altair(state, ctx, seed=6)
    eth1, changes = _capella_credentials(state, ctx, np.random.default_rng(7))
    committees = _committees_at_pre_slot(state, ctx, deneb)
    committee_keys = _realize_keys(state, [i for c in committees for i in c], known)
    churn = deneb.helpers.get_validator_churn_limit(state, ctx)
    activation_cap = deneb.helpers.get_validator_activation_churn_limit(state, ctx)
    scramble_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    settings = ctx.kzg_settings
    ceremony_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    elements = int(ctx.FIELD_ELEMENTS_PER_BLOB)
    blobs = [_blob(8 + k, elements) for k in range(DENEB_BLOBS + 1)]
    commitments = [kzg.blob_to_kzg_commitment(b, settings) for b in blobs]
    commit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scratch, proposer = _cross_for_block(state, ctx, deneb, known)
    reject_pre = type(scratch).serialize(scratch)
    withdrawals = _full_sweep("deneb", scratch, state, ctx)
    payload = _payload(deneb, scratch, ctx, proposer, withdrawals,
                       blob_gas_used=DENEB_BLOBS * DENEB_GAS_PER_BLOB, excess_blob_gas=0)
    block, signed = make_altair_block(scratch, ctx, committees, deneb, execution_payload=payload,
                                      bls_to_execution_changes=_bls_changes(state, ctx, changes),
                                      blob_kzg_commitments=commitments[:DENEB_BLOBS])
    del scratch
    tampered = block.copy()
    tampered.body.blob_kzg_commitments.append(commitments[DENEB_BLOBS])
    good = signed(block)
    block_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sidecars = _blob_sidecars(good, blobs[:DENEB_BLOBS], ctx)
    sidecars_s = time.perf_counter() - t0
    n = len(state.validators)
    t0 = time.perf_counter()
    pre = type(state).serialize(state)
    serialize_s = time.perf_counter() - t0
    before = _registry_before(pre, type(state))
    del state
    print(f"deneb: {n} validators; upgrade at slot "
          f"{CAPELLA_FORK_EPOCH * int(ctx.SLOTS_PER_EPOCH)} {upgrade_s:.1f} s; slots to "
          f"{ALTAIR_PRE_SLOT} {to_pre_s:.1f} s; scramble {scrambled}, {len(eth1)} 0x01 "
          f"validators, {len(changes)} withdrawal keys and {committee_keys} committee keys "
          f"{scramble_s:.1f} s; churn limit {churn}, activation cap {activation_cap}; ceremony "
          f"load {ceremony_s:.4f} s; {len(blobs)} blobs committed {commit_s:.2f} s; one scratch "
          f"crossing, its bytes and the block {block_s:.1f} s; {len(sidecars)} sidecars "
          f"{sidecars_s:.2f} s; serialize ({len(pre)} bytes) {serialize_s:.1f} s")
    return {"pre": pre, "ctx": ctx, "good": good, "tampered": signed(tampered),
            "reject_pre": reject_pre, "n": n, "before": before, "scrambled": scrambled,
            "proposer": proposer, "withdrawals": [int(w.validator_index) for w in withdrawals],
            "changes": [i for i, _ in changes], "blobs": blobs[:DENEB_BLOBS],
            "sidecars": sidecars, "churn_limit": churn, "activation_cap": activation_cap,
            "commitments": commitments[:DENEB_BLOBS],
            "setup_s": {"upgrade": upgrade_s, "to_pre": to_pre_s,
                        "scramble_and_keys": scramble_s, "ceremony_load": ceremony_s,
                        "commitments": commit_s, "block": block_s, "sidecars": sidecars_s,
                        "serialize": serialize_s}}


def _electra_at_fork(deneb_state) -> tuple:
    """The deneb state at the fork slot upgraded to electra (every fork from
    bellatrix on at epoch 2) through the port's upgrade_to_electra, whose
    registry scans read the deneb state's columns: a copy. Returns (the
    electra state, its context, seconds)."""
    from ethereum_consensus_tpu_torch.models import electra

    t0 = time.perf_counter()
    ctx = _forked_ctx("bellatrix", "capella", "deneb", "electra")
    state = electra.upgrade_to_electra(deneb_state, ctx)
    return state, ctx, time.perf_counter() - t0


def _eth1_credentials(address: bytes) -> bytes:
    return b"\x01" + b"\x00" * 11 + address


def _electra_work(state, ctx, rng) -> dict:
    """The EIP-7251 work of the electra cell on ``state`` (at slot 95, after
    the scramble and capella's credentials), on validators the scramble and
    the credentials left alone (active, unslashed, 32 ETH effective, 0x00
    credentials): the pending deposits, the pending consolidations (their
    sources exited at epoch 1, so the active set of epoch 2 loses them), the
    compounding validators and the pending partial withdrawals. Picks the
    block's withdrawal-request validators and its consolidation pair too.
    Returns the indices of each group."""
    from ethereum_consensus_tpu_torch.models import electra
    from ethereum_consensus_tpu_torch.models import ops_vector
    from ethereum_consensus_tpu_torch.primitives import FAR_FUTURE_EPOCH

    ns = electra.build(ctx.preset)
    inc = int(ctx.EFFECTIVE_BALANCE_INCREMENT)
    vc = ops_vector.columns_for(state).validator_columns(state)
    free = np.nonzero((vc["exit_epoch"] == np.uint64(FAR_FUTURE_EPOCH))
                      & (vc["activation_epoch"] == np.uint64(0)) & ~vc["slashed"]
                      & (vc["effective_balance"] == np.uint64(32 * inc))
                      & (vc["withdrawal_prefix"] == np.uint8(0)))[0]
    picks = rng.permutation(free).tolist()
    n = len(state.validators)
    sizes = {"compounding": n // ELECTRA_COMPOUNDING_SHARE,
             "targets": ELECTRA_CONSOLIDATIONS, "sources": ELECTRA_CONSOLIDATIONS + 2,
             "requests": ELECTRA_REQUESTS, "pair": 2, "deposits": ELECTRA_PENDING_DEPOSITS}
    groups, at = {}, 0
    for name, size in sizes.items():
        groups[name] = picks[at : at + size]
        at += size
    for k in range(ELECTRA_PENDING_DEPOSITS):
        state.pending_balance_deposits.append(
            ns.PendingBalanceDeposit(index=groups["deposits"][k], amount=inc))
    for i in groups["compounding"]:
        state.validators[i].withdrawal_credentials = (b"\x02" + b"\x00" * 11
                                                      + _withdrawal_address(i))
        state.balances[i] = int(rng.integers(33, 2101)) * inc + int(rng.integers(0, inc))
    rich = [i for i in groups["compounding"] if int(state.balances[i]) >= 40 * inc]
    groups["partials"] = rich[:ELECTRA_PARTIALS]
    for k, i in enumerate(groups["partials"]):
        state.pending_partial_withdrawals.append(ns.PendingPartialWithdrawal(
            index=i, amount=(k + 1) * inc, withdrawable_epoch=1 + k % 3))
    slashed = next(i for i in range(n) if state.validators[i].slashed)
    sources, targets = groups["sources"], groups["targets"]
    pairs = [(slashed, targets[0])] + list(zip(sources[:ELECTRA_CONSOLIDATIONS], targets))
    pairs += [(sources[-2], targets[1]), (sources[-1], targets[2])]
    for k, (src, tgt) in enumerate(pairs):
        address = _withdrawal_address(tgt)
        state.pending_consolidations.append(ns.PendingConsolidation(source_index=src,
                                                                    target_index=tgt))
        if src == slashed:
            continue
        v = state.validators[src]
        v.withdrawal_credentials = _eth1_credentials(address)
        v.exit_epoch = 1
        v.withdrawable_epoch = 9 if k == len(pairs) - 2 else 1  # the unripe one
        t = state.validators[tgt]
        t.withdrawal_credentials = _eth1_credentials(address)
        state.balances[tgt] = 32 * inc + int(rng.integers(inc, 5 * inc))
    for i in groups["requests"] + groups["pair"]:
        address = _withdrawal_address(groups["pair"][0] if i in groups["pair"] else i)
        state.validators[i].withdrawal_credentials = _eth1_credentials(address)
    for key in ("_active_idx_cache", "_proposer_cache", "_total_active_balance_cache",
                "_pubkey_index_cache"):
        state.__dict__.pop(key, None)
    groups["unripe"] = pairs[-2]
    return groups


def _expected_ejection_exits(state, ctx) -> dict:
    """The exit epochs the boundary gives the ejections of ``state`` (at slot
    95): electra's compute_exit_epoch_and_update_churn on the pre-state,
    each ejected validator in index order, the state's churn scalars put
    back after."""
    from ethereum_consensus_tpu_torch.models import electra, ops_vector
    from ethereum_consensus_tpu_torch.primitives import FAR_FUTURE_EPOCH

    h = electra.helpers
    epoch = np.uint64(h.get_current_epoch(state, ctx))
    vc = ops_vector.columns_for(state).validator_columns(state)
    ejected = np.nonzero((vc["activation_epoch"] <= epoch) & (epoch < vc["exit_epoch"])
                         & (vc["exit_epoch"] == np.uint64(FAR_FUTURE_EPOCH))
                         & (vc["effective_balance"] <= np.uint64(int(ctx.ejection_balance))))[0]
    scalars = (state.exit_balance_to_consume, state.earliest_exit_epoch)
    exits = {i: h.compute_exit_epoch_and_update_churn(
        state, int(state.validators[i].effective_balance), ctx) for i in ejected.tolist()}
    state.exit_balance_to_consume, state.earliest_exit_epoch = scalars
    return exits


def _expected_pending_deposits(state, ctx) -> tuple:
    """(deposits the boundary consumes, the deposit balance left to
    consume) of ``state``'s pending deposits under its activation-exit
    churn."""
    from ethereum_consensus_tpu_torch.models import electra

    available = int(state.deposit_balance_to_consume) + \
        electra.helpers.get_activation_exit_churn_limit(state, ctx)
    processed = consumed = 0
    for deposit in state.pending_balance_deposits:
        if processed + int(deposit.amount) > available:
            break
        processed += int(deposit.amount)
        consumed += 1
    return consumed, available - processed


def _spanning_aggregate(ns, h, scratch, ctx, slot: int, committees: list):
    """One committee-spanning aggregate of every committee of ``slot``
    (EIP-7549) over the honest vote on the crossed ``scratch``: one
    signature under the sum of the members' secret keys SecretKey(i + 1)."""
    from ethereum_consensus_tpu_torch.crypto import bls
    from ethereum_consensus_tpu_torch.crypto.fields import R
    from ethereum_consensus_tpu_torch.domains import DomainType
    from ethereum_consensus_tpu_torch.signing import compute_signing_root

    epoch = slot // int(ctx.SLOTS_PER_EPOCH)
    data = ns.AttestationData(
        slot=slot, index=0, beacon_block_root=h.get_block_root_at_slot(scratch, slot),
        source=scratch.previous_justified_checkpoint.copy(),
        target=ns.Checkpoint(epoch=epoch, root=h.get_block_root(scratch, epoch, ctx)))
    root = compute_signing_root(ns.AttestationData, data,
                                h.get_domain(scratch, DomainType.BEACON_ATTESTER, epoch, ctx))
    members = [i for c in committees for i in c]
    return ns.Attestation(
        aggregation_bits=[True] * len(members), data=data,
        committee_bits=[k < len(committees) for k in range(int(ctx.MAX_COMMITTEES_PER_SLOT))],
        signature=bls.SecretKey(sum(i + 1 for i in members) % R).sign(root).to_bytes())


def _electra_operations(state, ctx, groups: dict) -> tuple:
    """The block's deposit receipts (ELECTRA_RECEIPTS - 1 top-ups of
    existing validators, then one new validator SecretKey(n + 1) with a
    valid signature), its withdrawal requests (full exits of the request
    validators from their 0x01 addresses) and its consolidation (the pair,
    signed by both keys; and the tampered one, by the source's alone)."""
    from ethereum_consensus_tpu_torch.crypto import bls
    from ethereum_consensus_tpu_torch.domains import DomainType
    from ethereum_consensus_tpu_torch.models import electra
    from ethereum_consensus_tpu_torch.models.phase0.containers import DepositMessage
    from ethereum_consensus_tpu_torch.signing import compute_signing_root

    ns, h = electra.build(ctx.preset), electra.helpers
    inc = int(ctx.EFFECTIVE_BALANCE_INCREMENT)
    n = len(state.validators)
    start = int(state.eth1_deposit_index)
    receipts = []
    for k, i in enumerate(groups["deposits"][: ELECTRA_RECEIPTS - 1]):
        v = state.validators[i]
        receipts.append(ns.DepositReceipt(
            public_key=bytes(v.public_key), withdrawal_credentials=bytes(v.withdrawal_credentials),
            amount=(k + 1) * inc, signature=b"\x00" * 96, index=start + k))
    key = bls.SecretKey(n + 1)
    message = DepositMessage(public_key=key.public_key().to_bytes(),
                             withdrawal_credentials=_eth1_credentials(_withdrawal_address(n)),
                             amount=32 * inc)
    root = compute_signing_root(DepositMessage, message,
                                h.compute_domain(DomainType.DEPOSIT, None, None, ctx))
    receipts.append(ns.DepositReceipt(
        public_key=message.public_key, withdrawal_credentials=message.withdrawal_credentials,
        amount=message.amount, signature=key.sign(root).to_bytes(),
        index=start + ELECTRA_RECEIPTS - 1))
    requests = [ns.ExecutionLayerWithdrawalRequest(
        source_address=_withdrawal_address(i),
        validator_public_key=bytes(state.validators[i].public_key), amount=0)
        for i in groups["requests"]]
    source, target = groups["pair"]
    consolidation = ns.Consolidation(source_index=source, target_index=target, epoch=0)
    root = compute_signing_root(ns.Consolidation, consolidation, h.compute_domain(
        DomainType.CONSOLIDATION, None, bytes(state.genesis_validators_root), ctx))
    signed = ns.SignedConsolidation(message=consolidation, signature=bls.aggregate(
        [bls.SecretKey(source + 1).sign(root), bls.SecretKey(target + 1).sign(root)]).to_bytes())
    tampered = ns.SignedConsolidation(message=consolidation.copy(),
                                      signature=bls.SecretKey(source + 1).sign(root).to_bytes())
    return receipts, requests, signed, tampered


def build_electra_pre_state(state, ctx, upgrade_s: float, known: dict,
                            commitments: list) -> dict:
    """The electra cell's pre-state from ``state`` (``_electra_at_fork``'s,
    at the fork slot 64): slots to 95 under electra rules, the altair
    scramble under a seed of its own, capella's credentials and changes,
    ``_electra_work``, the keys of slots 94 and 95's committees, of the
    consolidation pair and of the slot-96 proposer made real (``known``);
    then a signed electra block at slot 96 with the two committee-spanning
    aggregates, a full sync aggregate, the payload of ``_payload`` with the
    expected withdrawals, the receipts and the requests, the changes, the
    deneb cell's ``commitments`` and the consolidation; the tampered copy's
    consolidation signed by the source alone. Returns what the checks of
    ``_electra_checks`` read besides the pre-state's bytes, the blocks and
    the crossed scratch's bytes."""
    from ethereum_consensus_tpu_torch.models import electra

    ns, h = electra.build(ctx.preset), electra.helpers
    t0 = time.perf_counter()
    electra.slot_processing.process_slots(state, ALTAIR_PRE_SLOT, ctx)
    to_pre_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scrambled = scramble_altair(state, ctx, seed=10)
    eth1, changes = _capella_credentials(state, ctx, np.random.default_rng(7))
    groups = _electra_work(state, ctx, np.random.default_rng(11))
    work_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    per_slot = h.get_committee_count_per_slot(state, ALTAIR_PRE_SLOT // int(ctx.SLOTS_PER_EPOCH),
                                              ctx)
    committees = {slot: [h.get_beacon_committee(state, slot, index, ctx)
                         for index in range(per_slot)] for slot in ELECTRA_ATTESTED_SLOTS}
    keys = _realize_keys(state, [i for c in committees.values() for m in c for i in m]
                         + groups["pair"], known)
    keys_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    exits = _expected_ejection_exits(state, ctx)
    consumed, left = _expected_pending_deposits(state, ctx)
    churn = h.get_activation_exit_churn_limit(state, ctx)
    finalized = int(state.finalized_checkpoint.epoch)
    expected_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    receipts, requests, consolidation, tampered_consolidation = _electra_operations(
        state, ctx, groups)
    scratch, proposer = _cross_for_block(state, ctx, electra, known)
    reject_pre = type(scratch).serialize(scratch)
    withdrawals, partials = electra.block_processing.get_expected_withdrawals(scratch, ctx)
    if len(withdrawals) != int(ctx.MAX_WITHDRAWALS_PER_PAYLOAD) or \
            partials != int(ctx.MAX_PENDING_PARTIALS_PER_WITHDRAWALS_SWEEP):
        sys.exit(f"chip_smoke: the electra payload would carry {len(withdrawals)} withdrawals, "
                 f"{partials} of them pending partials")
    payload = _payload(electra, scratch, ctx, proposer, withdrawals,
                       blob_gas_used=DENEB_BLOBS * DENEB_GAS_PER_BLOB, excess_blob_gas=0,
                       deposit_receipts=receipts, withdrawal_requests=requests)
    attestations = [_spanning_aggregate(ns, h, scratch, ctx, slot, committees[slot])
                    for slot in ELECTRA_ATTESTED_SLOTS]
    block, signed = _altair_block(scratch, ctx, ALTAIR_BLOCK_SLOT, attestations, electra,
                                  execution_payload=payload,
                                  bls_to_execution_changes=_bls_changes(state, ctx, changes),
                                  blob_kzg_commitments=list(commitments),
                                  consolidations=[consolidation])
    del scratch
    tampered = block.copy()
    tampered.body.consolidations[0] = tampered_consolidation
    good = signed(block)
    block_s = time.perf_counter() - t0
    n = len(state.validators)
    pre_deposits = [(int(d.index), int(d.amount)) for d in state.pending_balance_deposits]
    t0 = time.perf_counter()
    pre = type(state).serialize(state)
    serialize_s = time.perf_counter() - t0
    before = _registry_before(pre, type(state))
    del state
    signers = [len(a.aggregation_bits) for a in attestations]
    print(f"electra: {n} validators; upgrade at slot "
          f"{CAPELLA_FORK_EPOCH * int(ctx.SLOTS_PER_EPOCH)} {upgrade_s:.1f} s; slots to "
          f"{ALTAIR_PRE_SLOT} {to_pre_s:.1f} s; scramble {scrambled}, {len(eth1)} 0x01 "
          f"validators, {len(changes)} withdrawal keys, {len(groups['compounding'])} 0x02 "
          f"validators, {len(pre_deposits)} pending deposits, {ELECTRA_CONSOLIDATIONS + 3} "
          f"pending consolidations, {len(groups['partials'])} pending partial withdrawals "
          f"{work_s:.1f} s; {keys} keys of slots {ELECTRA_ATTESTED_SLOTS}' committees and the "
          f"consolidation pair {keys_s:.1f} s; expected boundary {expected_s:.1f} s ({len(exits)} "
          f"ejections, {consumed} deposits under the churn {churn}); one scratch crossing, its "
          f"bytes and the block {block_s:.1f} s (aggregates of {signers} signers); serialize "
          f"({len(pre)} bytes) {serialize_s:.1f} s")
    return {"pre": pre, "ctx": ctx, "good": good, "tampered": signed(tampered),
            "reject_pre": reject_pre, "n": n, "before": before, "scrambled": scrambled,
            "proposer": proposer, "withdrawals": [int(w.validator_index) for w in withdrawals],
            "changes": [i for i, _ in changes], "groups": groups, "exits": exits,
            "consumed": consumed, "deposit_balance_left": left, "pre_deposits": pre_deposits,
            "churn": churn, "finalized": finalized, "signers": signers,
            "receipts": [(int(groups["deposits"][k]) if k < ELECTRA_RECEIPTS - 1 else n,
                          int(r.amount)) for k, r in enumerate(receipts)],
            "setup_s": {"upgrade": upgrade_s, "to_pre": to_pre_s, "scramble_and_work": work_s,
                        "keys": keys_s, "expected": expected_s, "block": block_s,
                        "serialize": serialize_s}}


def _electra_checks(post, columns: tuple, setup: dict) -> dict:
    """The electra cell's boundary and block on ``post`` and the columns of
    its bytes (``_serialized_columns``): every eligible
    entrant activated, the churn's worth of pending deposits consumed and
    the rest kept in order, the consolidations up to the unripe one
    processed (the slashed one skipped; the block's own queued behind the
    rest) and their targets on 0x02, no
    effective balance above MAX_EFFECTIVE_BALANCE_ELECTRA and some above 32
    ETH, the ejections' exit epochs, MAX_PENDING_PARTIALS_PER_WITHDRAWALS_SWEEP
    partials withdrawn, the requests no-ops, the consolidation's source
    exiting. Returns each check's verdict."""
    from ethereum_consensus_tpu_torch.primitives import FAR_FUTURE_EPOCH as far

    ctx, groups = setup["ctx"], setup["groups"]
    before = setup["before"]
    inc = int(ctx.EFFECTIVE_BALANCE_INCREMENT)
    eligible = [i for i in before["pending"] if before["eligibility"][i] <= setup["finalized"]]
    left = setup["pre_deposits"][setup["consumed"]:]
    post_deposits = [(int(d.index), int(d.amount)) for d in post.pending_balance_deposits]
    targets = groups["targets"]
    queued = post_deposits[len(left):]
    records = columns[0]
    effective = records["effective_balance"]
    unripe = groups["unripe"]
    checks = {
        "entrants activated": bool(eligible) and bool(
            (records["activation_epoch"][eligible] != np.uint64(far)).all()),
        "deposits consumed": post_deposits[: len(left)] == left
        and int(post.deposit_balance_to_consume) == setup["deposit_balance_left"],
        "excesses, then receipts, queued": [i for i, _ in queued] == targets + [
            i for i, _ in setup["receipts"]] and [a for _, a in queued[ELECTRA_CONSOLIDATIONS:]]
        == [a for _, a in setup["receipts"]],
        "consolidations": [(int(c.source_index), int(c.target_index))
                           for c in post.pending_consolidations] == [
            tuple(unripe), (groups["sources"][-1], targets[2]), tuple(groups["pair"])],
        "targets on 0x02": bool((records["withdrawal_credentials"][targets, 0] == 2).all()),
        "effective balances capped": int(effective.max()) <= int(
            ctx.MAX_EFFECTIVE_BALANCE_ELECTRA) and int((effective > 32 * inc).sum()) > 0,
        "ejection exits": bool(setup["exits"]) and all(
            int(records["exit_epoch"][i]) == e for i, e in setup["exits"].items()),
        "partials left": len(post.pending_partial_withdrawals)
        == ELECTRA_PARTIALS - int(ctx.MAX_PENDING_PARTIALS_PER_WITHDRAWALS_SWEEP),
        "requests no-ops": bool(
            (records["exit_epoch"][groups["requests"]] == np.uint64(far)).all()),
        "consolidation source exiting": int(records["exit_epoch"][groups["pair"][0]]) != far,
        "new validator": len(records) == setup["n"] + 1,
    }
    return {"checks": checks, "activated": len(eligible),
            "above_32": int((effective > 32 * inc).sum()), "max_effective": int(effective.max()),
            "ejections": len(setup["exits"])}


def _data_available(sidecars: list, body_root: bytes, ctx) -> bool:
    """The node's data-availability check of a block's blob sidecars: each
    sidecar's header names the block's body and its commitment's inclusion
    proof holds against it, then one KZG batch verification of every blob
    against its commitment and proof (the host's native library)."""
    from ethereum_consensus_tpu_torch.crypto import kzg
    from ethereum_consensus_tpu_torch.models import deneb

    body_type = deneb.build(ctx.preset).BeaconBlockBody
    for sidecar in sidecars:
        if bytes(sidecar.signed_block_header.message.body_root) != body_root or \
                not deneb.blob_sidecar.verify_blob_sidecar_inclusion_proof(sidecar, body_type,
                                                                           ctx):
            return False
    return kzg.verify_blob_kzg_proof_batch(
        [bytes(s.blob) for s in sidecars], [bytes(s.kzg_commitment) for s in sidecars],
        [bytes(s.kzg_proof) for s in sidecars], ctx.kzg_settings)


def _data_availability(setup: dict) -> dict:
    """The deneb block's data-availability check, timed, on its six
    sidecars; then on a copy with one field element of one blob changed
    and on one with one node of one inclusion proof changed. Fails the run
    unless the verdicts are true, false and false."""
    from ethereum_consensus_tpu_torch.crypto import bls
    from ethereum_consensus_tpu_torch.models import deneb

    if bls.backend_name() != "native":
        sys.exit("chip_smoke: the data-availability check needs the native library")
    ctx, sidecars = setup["ctx"], setup["sidecars"]
    body_root = deneb.build(ctx.preset).BeaconBlockBody.hash_tree_root(
        setup["good"].message.body)
    verdicts, walls = {}, {}
    blob_index, element = DENEB_CHANGED_ELEMENT
    changed_blob = [s.copy() for s in sidecars]
    blob = bytearray(changed_blob[blob_index].blob)
    blob[32 * element + 31] ^= 1
    changed_blob[blob_index].blob = bytes(blob)
    sidecar_index, node = DENEB_CHANGED_NODE
    changed_node = [s.copy() for s in sidecars]
    proof = changed_node[sidecar_index].kzg_commitment_inclusion_proof
    proof[node] = hashlib.sha256(bytes(proof[node])).digest()
    for name, candidate in (("blobs", sidecars), ("changed_element", changed_blob),
                            ("changed_node", changed_node)):
        t0 = time.perf_counter()
        verdicts[name] = _data_available(candidate, body_root, ctx)
        walls[name] = time.perf_counter() - t0
    print(f"deneb data availability: {len(sidecars)} sidecars, verdicts {verdicts}, walls "
          f"{_rounded(walls, 4)} s")
    if verdicts != {"blobs": True, "changed_element": False, "changed_node": False}:
        sys.exit(f"chip_smoke: the deneb data-availability verdicts are off: {verdicts}")
    return {"verdicts": verdicts, "walls_s": walls}


def _apply_altair(state, signed_block, ctx, timers: list, events: "list | None", fork=None):
    """Cold Executor.apply_block of a block of ``fork`` (altair by default)
    with host timers on ``timers`` ((module, name, key) triples) and CUDA
    events on each kernel launch; returns (seconds, parts, executor state)."""
    from ethereum_consensus_tpu_torch.crypto import bls
    from ethereum_consensus_tpu_torch.executor import Executor
    from ethereum_consensus_tpu_torch.models import altair, transition
    from ethereum_consensus_tpu_torch.ops import epoch, g1, merkle, sha256, shuffle, sweeps

    state_transition = (fork or altair).state_transition
    parts: dict = {}
    with contextlib.ExitStack() as stack:
        for module, name, key in [(transition, "process_slot_generic", "slot_root"),
                                  (state_transition, "process_block", "process_block"),
                                  (bls, "verify_signature_sets", "signature_batch"), *timers]:
            stack.enter_context(_patched(module, name, _host_timer(parts, key)))
        if events is not None:
            for module, name, key in (
                    (sha256, "sha256_64b_cuda", "sha256_64b"), (shuffle, "_launch", "shuffle"),
                    (g1, "_launch", "g1_sum_sets"), (sweeps, "_launch", "effective_balance"),
                    (epoch, "_launch", "fused_epoch"),
                    (merkle, "reduce_levels_cuda", "merkle_levels"),
                    (epoch, "fused_flag_sums_cuda", "fused_flag_sums"),
                    (epoch, "fused_epoch_apply_cuda", "fused_epoch_apply"),
                    (epoch, "rewards_apply_cuda", "rewards_apply"),
                    (sweeps, "_launch_flag_deltas", "flag_deltas"),
                    (sweeps, "_launch_inactivity_updates", "inactivity_updates"),
                    (sweeps, "_launch_inactivity_penalties", "inactivity_penalties")):
                stack.enter_context(_patched(module, name, _event_timer(events, key)))
        executor = Executor(state, ctx)
        gc.collect()
        gc.freeze()
        try:
            t0 = time.perf_counter()
            executor.apply_block(signed_block)
            if events is not None:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            gc.unfreeze()
    return seconds, parts, executor.state.data


# launches of the literal stages' sweep kernels (none on the engine's routes)
LITERAL_SWEEPS = {"flag_deltas": 3, "inactivity_updates": 1, "inactivity_penalties": 1,
                  "effective_balance": 1}


def _boundary_changes(columns: tuple, setup: dict) -> tuple:
    """What the boundary changed against the set-up's ``before``, on the
    columns of the post-state's bytes (``_serialized_columns``): the
    counts of changed balances, scores and effective balances, and how many
    of the pre-state's pending validators it activated."""
    from ethereum_consensus_tpu_torch.primitives import FAR_FUTURE_EPOCH

    n = setup["n"]
    before = setup["before"]
    records, balances, scores = columns
    changed = {
        "balances": int((balances[:n] != before["balances"]).sum()),
        "scores": int((scores[:n] != before["scores"]).sum()),
        "effective": int((records["effective_balance"][:n] != before["effective"]).sum()),
    }
    activated = int((records["activation_epoch"][before["pending"]]
                     != np.uint64(FAR_FUTURE_EPOCH)).sum())
    return changed, activated


def _cell_routes(cell: str, setup: dict, routes: dict, fork) -> dict:
    """Each route of ``routes`` (name -> (installed, literal, timers)) on the
    cell's pre-state read anew from SSZ: the cold apply of its block through
    Executor.apply_block with its buckets, the launch counts from 0, the
    engine's passes and declines, the tampered block (not on the literal
    route) on the crossed scratch state the good block was built on, read
    once from the set-up's ``reject_pre`` at the block's slot (a copy of it
    for each route but the last): the boundary is the good block's, so a
    cold crossing a route is spared; every route's post-state bytes and
    root must agree. What the boundary changed, and the set-up's
    ``post_check`` where it has one, are read on the first route's
    post-state bytes: the others' are the same bytes."""
    from ethereum_consensus_tpu_torch import ops
    from ethereum_consensus_tpu_torch.telemetry import metrics

    pre, ctx, good, tampered = setup["pre"], setup["ctx"], setup["good"], setup["tampered"]
    reject_pre = setup["reject_pre"]
    state_type = fork.build(ctx.preset).BeaconState
    engaged = metrics.counter("epoch_vector.epochs")
    disabled = metrics.counter("epoch_vector.fallback.disabled")

    def fused_fallbacks() -> int:
        return sum(metrics.counter(k).value() for k in metrics.registered()
                   if k.startswith("epoch_vector.fused_fallback."))

    started = time.perf_counter()
    results, digest, root = {}, None, None
    rejecting = [name for name, (_, literal, _) in routes.items() if not literal]
    reject_base = None
    for name, (installed, literal, timers) in routes.items():
        ops.uninstall()  # clears the shuffle cache: each route shuffles anew
        t0 = time.perf_counter()
        # _apply_altair freezes what the read made: no collection of its
        # own during the read
        with _collector_paused():
            state = state_type.deserialize(pre)
        read_s = time.perf_counter() - t0
        if literal:
            os.environ["ECT_EPOCH_VECTOR"] = "off"
        try:
            if installed:
                ops.install(device="cuda")
            events: list = [] if installed else None
            counts = (engaged.value(), disabled.value(), fused_fallbacks())
            _zero_launch_counts()
            seconds, parts, post = _apply_altair(state, good, ctx, timers, events, fork)
            launches = _launch_counts()
            moved = (engaged.value() - counts[0], disabled.value() - counts[1],
                     fused_fallbacks() - counts[2])
            with _collector_paused():
                error = None
                if not literal:
                    if reject_base is None:
                        reject_base = state_type.deserialize(reject_pre)
                    reject_state = reject_base if name == rejecting[-1] else reject_base.copy()
                    error = _rejection_in_slot(reject_state, tampered, ctx, fork)
                    del reject_state
        finally:
            os.environ.pop("ECT_EPOCH_VECTOR", None)
            ops.uninstall()
        with _collector_paused():
            data = state_type.serialize(post)
            this_digest = hashlib.sha256(data).hexdigest()
            this_root = state_type.hash_tree_root(post)
            if digest is None:
                columns = _serialized_columns(data, state_type)
                changed, activated = _boundary_changes(columns, setup)
                checked = (setup["post_check"](post, columns, setup) if "post_check" in setup
                           else None)
                del columns
        kernel_ms: dict = {}
        for kname, start, end in events or ():
            kernel_ms[kname] = kernel_ms.get(kname, 0.0) + start.elapsed_time(end)
        if literal:
            parts["write_back"] = (parts["process_inactivity_updates"]
                                   + parts["process_rewards_and_penalties"]
                                   + parts["process_effective_balance_updates"]
                                   - parts["pack"] - parts["kernel_call"])
        idle = 1.0 - sum(kernel_ms.values()) / (1e3 * seconds) if installed else None
        print(f"{cell} {name}: read {read_s:.1f} s; apply {seconds:.3f} s {_rounded(parts)}; "
              f"columnar passes {moved[0]}, engine disabled {moved[1]}, fused declines "
              f"{moved[2]}; launches {launches}"
              + (f"; kernel ms inside {_rounded(kernel_ms, 4)}; idle share {idle:.6f}"
                 if installed else ""))
        print(f"{cell} {name}: post-state sha256 {this_digest}, root {this_root.hex()}; "
              f"changed {changed}, activated {activated}"
              + (f"; checks {checked}" if checked is not None and digest is None else "")
              + (f"; tampered block: {error!r}" if error else ""))
        results[name] = {"read_s": read_s, "apply_s": seconds, "parts_s": parts,
                         "launches": launches, "kernel_ms_inside": kernel_ms, "idle_share": idle,
                         "engine": moved, "changed": changed, "activated": activated,
                         "rejection": error}
        if digest is None:
            digest, root = this_digest, this_root
        elif (this_digest, this_root) != (digest, root):
            sys.exit(f"chip_smoke: the {cell} block's post-state on the {name} route differs")
        if min(changed.values()) == 0:
            sys.exit(f"chip_smoke: the {cell} boundary changed nothing on the {name} route")
        del state, post, data
    del reject_base

    host, device = results["host"], results["device"]
    if host["engine"] != (1, 0, 0) or device["engine"] != (1, 0, 0):
        sys.exit(f"chip_smoke: the columnar engine did not engage without declines on the "
                 f"{cell} host and device paths")
    want_device = {"fused_epoch": 1, "g1_sum_sets": G1_SUM_LAUNCHES}
    if any(device["launches"][k] != v for k, v in want_device.items()) or \
            device["launches"]["sha256_64b"] == 0 or any(device["launches"][k] for k in
                                                         LITERAL_SWEEPS):
        sys.exit(f"chip_smoke: the {cell} device path's launches are off: {device['launches']}")
    if any(host["launches"].values()):
        sys.exit(f"chip_smoke: the {cell} host path launched a kernel: {host['launches']}")
    if host["rejection"] != device["rejection"]:
        sys.exit(f"chip_smoke: the {cell} tampered block was not rejected alike on both paths")
    wall = time.perf_counter() - started
    print(f"{cell}: {len(routes)} routes {wall:.1f} s wall")
    return {"routes": results, "root": root.hex(), "sha256": digest, "routes_s": wall,
            "checked": checked}


def phase_altair(registry: dict) -> dict:
    """The slice's main paths, each block at the first slot of epoch 3 on a
    2^20-validator mainnet state, through Executor.apply_block: one signed
    altair block on the host path (the columnar engine, staged host
    kernels), after ops.install(device="cuda") (the engine with B3), and on
    the literal device route (ECT_EPOCH_VECTOR=off: the literal stages with
    the B5 kernels); then one signed capella block (after the upgrades to
    bellatrix and capella, the boundary under capella rules, withdrawals
    and BLS-to-execution changes) on the host and device paths, and one
    signed deneb block (after the upgrade to deneb as well, the boundary
    under deneb rules with EIP-7514's activation cap, six blob commitments)
    on the host and device paths, then its blobs' data-availability check;
    and one signed electra block (after the upgrade to electra as well, the
    boundary under electra rules: unbounded activations, the
    balance-weighted exit churn, the pending deposits and consolidations,
    the compounding cap; two committee-spanning aggregates, deposit
    receipts, withdrawal requests and a consolidation) on the host and
    device paths, then B6 alone at that block's sets. Identical bytes and
    roots on every route of a cell."""
    from ethereum_consensus_tpu_torch.crypto import bls
    from ethereum_consensus_tpu_torch.models import altair, capella, deneb, electra, epoch_vector
    from ethereum_consensus_tpu_torch.models.altair import epoch_processing as aep
    from ethereum_consensus_tpu_torch.ops import epoch as ops_epoch
    from ethereum_consensus_tpu_torch.ops import sweeps

    with _collector_paused():
        setup = build_altair_pre_state(registry)
    good = setup["good"]
    n_keys = sum(len(a.aggregation_bits) for a in good.message.body.attestations) + 2
    n_keys += len(good.message.body.sync_aggregate.sync_committee_bits)
    print(f"altair: block at slot {ALTAIR_BLOCK_SLOT}: {len(good.message.body.attestations)} "
          f"attestations, a full sync aggregate; {n_keys} keys in the signature batch")

    engine_stages = [(epoch_vector, name, name.strip("_")) for name in (
        "_sync", "_justification_altair", "_inactivity_and_rewards", "_registry_updates",
        "_slashings", "_effective_balance_updates", "_commit")]
    literal_stages = [(aep, name, name) for name in (
        "process_justification_and_finalization", "process_inactivity_updates",
        "process_rewards_and_penalties", "process_registry_updates", "process_slashings",
        "process_effective_balance_updates")] + [
        (sweeps, "pack_registry", "pack"),
        (sweeps, "flag_deltas_device", "kernel_call"),
        (sweeps, "inactivity_updates_device", "kernel_call"),
        (sweeps, "inactivity_penalties_device", "kernel_call"),
        (sweeps, "effective_balance_updates_device", "kernel_call")]
    fused_call = (ops_epoch, "fused_epoch_device", "fused_call")
    cell = _cell_routes("altair", setup, {
        "host": (False, False, engine_stages),
        "device": (True, False, engine_stages + [fused_call]),
        "literal": (True, True, literal_stages),
    }, altair)
    host, device, literal = (cell["routes"][k] for k in ("host", "device", "literal"))
    if literal["engine"][:2] != (0, 1):
        sys.exit("chip_smoke: the literal route did not run the literal stages")
    if any(literal["launches"][k] != v for k, v in LITERAL_SWEEPS.items()) or \
            literal["launches"]["fused_epoch"]:
        sys.exit(f"chip_smoke: the literal route's launches are off: {literal['launches']}")
    if not (host["rejection"] or "").startswith("InvalidSyncAggregate"):
        sys.exit("chip_smoke: the altair tampered block was not refused for its sync aggregate")

    capella_setup = setup["capella"]
    block = capella_setup["good"].message
    print(f"capella: block at slot {ALTAIR_BLOCK_SLOT}: {len(block.body.attestations)} "
          f"attestations, a full sync aggregate, "
          f"{len(block.body.execution_payload.withdrawals)} withdrawals, "
          f"{len(block.body.bls_to_execution_changes)} BLS-to-execution changes; "
          f"{n_keys + len(block.body.bls_to_execution_changes)} keys in the signature batch")
    capella_stages = engine_stages + [
        (capella.block_processing, "_sweep_hits_vectorized", "withdrawal_sweep"),
        (capella.block_processing, "_get_expected_withdrawals_loop", "withdrawal_loop"),
        (capella.epoch_processing, "process_historical_summaries_update", "summaries")]
    capella_cell = _cell_routes("capella", capella_setup, {
        "host": (False, False, capella_stages),
        "device": (True, False, capella_stages + [fused_call]),
    }, capella)
    capella_host = capella_cell["routes"]["host"]
    if not (capella_host["rejection"] or "").startswith("InvalidWithdrawals"):
        sys.exit("chip_smoke: the capella tampered block was not refused for its withdrawals")
    churn = int(capella_cell["routes"]["host"]["activated"])
    if any(route["activated"] != churn for route in capella_cell["routes"].values()):
        sys.exit("chip_smoke: the capella routes activated different counts")

    deneb_setup = setup["deneb"]
    block = deneb_setup["good"].message
    print(f"deneb: block at slot {ALTAIR_BLOCK_SLOT}: {len(block.body.attestations)} "
          f"attestations, a full sync aggregate, "
          f"{len(block.body.execution_payload.withdrawals)} withdrawals, "
          f"{len(block.body.bls_to_execution_changes)} BLS-to-execution changes, "
          f"{len(block.body.blob_kzg_commitments)} blob commitments; "
          f"{n_keys + len(block.body.bls_to_execution_changes)} keys in the signature batch")
    deneb_stages = capella_stages + [
        (deneb.block_processing, "process_execution_payload", "execution_payload")]
    deneb_cell = _cell_routes("deneb", deneb_setup, {
        "host": (False, False, deneb_stages),
        "device": (True, False, deneb_stages + [fused_call]),
    }, deneb)
    if not (deneb_cell["routes"]["host"]["rejection"] or "").startswith("InvalidBlobData"):
        sys.exit("chip_smoke: the deneb block with a seventh commitment was not refused for "
                 "its blob data")
    cap = deneb_setup["activation_cap"]
    print(f"deneb: the boundary activated {deneb_cell['routes']['host']['activated']} of the "
          f"queue (EIP-7514's cap min({int(deneb_setup['ctx'].max_per_epoch_activation_churn_limit)}"
          f", churn limit {deneb_setup['churn_limit']}) = {cap}); the capella boundary "
          f"activated {churn}")
    if any(route["activated"] != cap for route in deneb_cell["routes"].values()):
        sys.exit("chip_smoke: the deneb boundary did not activate EIP-7514's cap")
    availability = _data_availability(deneb_setup)

    electra_setup = setup["electra"]
    block = electra_setup["good"].message
    electra_keys = sum(electra_setup["signers"]) + 2 + len(
        block.body.sync_aggregate.sync_committee_bits) + len(block.body.bls_to_execution_changes) + 2
    print(f"electra: block at slot {ALTAIR_BLOCK_SLOT}: {len(block.body.attestations)} "
          f"committee-spanning attestations of {electra_setup['signers']} signers, a full sync "
          f"aggregate, {len(block.body.execution_payload.withdrawals)} withdrawals, "
          f"{len(block.body.execution_payload.deposit_receipts)} deposit receipts, "
          f"{len(block.body.execution_payload.withdrawal_requests)} withdrawal requests, "
          f"{len(block.body.consolidations)} consolidation, "
          f"{len(block.body.bls_to_execution_changes)} BLS-to-execution changes, "
          f"{len(block.body.blob_kzg_commitments)} blob commitments; {electra_keys} keys in the "
          f"signature batch")
    electra_stages = engine_stages + [
        (epoch_vector, "_pending_balance_deposits", "pendings"),
        (epoch_vector, "_pending_consolidations", "pendings"),
        (electra.block_processing, "_sweep_hits_vectorized", "withdrawal_sweep"),
        (electra.block_processing, "process_execution_payload", "execution_payload"),
        (capella.epoch_processing, "process_historical_summaries_update", "summaries")]
    captured: list = []

    def capture(verify):
        def recording(sets, *args, **kwargs):
            if not captured:
                captured.append(list(sets))
            return verify(sets, *args, **kwargs)
        return recording

    with _patched(bls, "verify_signature_sets", capture):
        electra_cell = _cell_routes("electra", electra_setup, {
            "host": (False, False, electra_stages),
            "device": (True, False, electra_stages + [fused_call]),
        }, electra)
    checked = electra_cell["checked"]
    print(f"electra: the boundary activated {checked['activated']} eligible entrants "
          f"(deneb's 8), consumed {electra_setup['consumed']} of "
          f"{len(electra_setup['pre_deposits'])} pending deposits under the churn "
          f"{electra_setup['churn']}, exited {checked['ejections']} ejections; "
          f"{checked['above_32']} effective balances above 32 ETH, the largest "
          f"{checked['max_effective']}; checks {checked['checks']}")
    if not all(checked["checks"].values()):
        sys.exit(f"chip_smoke: the electra cell's checks failed: {checked['checks']}")
    electra_routes = electra_cell["routes"]
    if any(route["activated"] != checked["activated"] for route in electra_routes.values()):
        sys.exit("chip_smoke: the electra boundary did not activate every eligible entrant")
    if not (electra_routes["host"]["rejection"] or "").startswith("InvalidConsolidation"):
        sys.exit("chip_smoke: the electra block with the source's signature alone on its "
                 "consolidation was not refused for its consolidation")
    electra_g1 = _block_g1_sum("electra", captured[0] if captured else [])
    for cell_name, cell_routes in (("capella", capella_cell), ("deneb", deneb_cell),
                                   ("electra", electra_cell)):
        for route in cell_routes["routes"].values():
            if "withdrawal_sweep" not in route["parts_s"] or \
                    "withdrawal_loop" in route["parts_s"]:
                sys.exit(f"chip_smoke: the {cell_name} withdrawals did not come from the "
                         "registry's columns")
    return {"validators": setup["n"], "state_bytes": len(setup["pre"]),
            "setup_s": setup["setup_s"], "scrambled": setup["scrambled"], "keys": n_keys,
            "routes": cell["routes"], "root": cell["root"], "sha256": cell["sha256"],
            "capella": {"validators": capella_setup["n"],
                        "state_bytes": len(capella_setup["pre"]),
                        "setup_s": capella_setup["setup_s"],
                        "withdrawals": capella_setup["withdrawals"],
                        "changes": capella_setup["changes"], **capella_cell},
            "deneb": {"validators": deneb_setup["n"], "state_bytes": len(deneb_setup["pre"]),
                      "setup_s": deneb_setup["setup_s"],
                      "withdrawals": deneb_setup["withdrawals"],
                      "changes": deneb_setup["changes"], "churn_limit": deneb_setup["churn_limit"],
                      "activation_cap": cap, "data_availability": availability, **deneb_cell},
            "electra": {"validators": electra_setup["n"], "state_bytes": len(electra_setup["pre"]),
                        "setup_s": electra_setup["setup_s"],
                        "withdrawals": electra_setup["withdrawals"],
                        "signers": electra_setup["signers"], "churn": electra_setup["churn"],
                        "consumed": electra_setup["consumed"], "g1": electra_g1, **electra_cell},
            # for the mesh phase, which applies the same block on ECT_MESH=1
            "pre": setup["pre"], "ctx": setup["ctx"], "good": good, "before": setup["before"]}


# --- the batched pairing (B7) and the verification window --------------------

# Lane counts of the pairing phase's checks; the last is the window's 528
# sets (8 blocks of 64 aggregates, a proposer and a randao set).
PAIRING_CHECK_NS = (1, 2, 3, 64, 528)
PAIRING_PLAIN_MILLER_LANES = 64
PAIRING_TAMPERED_SET = 5
# Multiply-adds of the least work of each B7 function, whatever formulas the
# kernels use. Over Fp2 a product takes 3 Fp multiplications (Karatsuba), a
# square 2 (complex squaring) and a product by an Fp scalar 2. G1: doubling
# dbl-2009-l (2 multiplications, 5 squarings), and the affine base added by
# the mixed addition (G1_MIXED_ADD_MADS). G2, over Fp2: doubling 2 products
# and 5 squares, the affine base added by the mixed addition (7 and 4: it
# gives the coordinates of the reference's general formula at Z2 = 1), two
# lanes' sums by add-2007-bl (11 and 5, the same coordinates as the
# reference's 12 and 4). Fq12: Karatsuba Fq6 of 6 Fp2 products, so a
# product 18, a squaring 12 (two Fq6 products) and the sparse line product
# 13 (over Fp4 = Fp2[w^3] the line is (c00 + c11 w^3) + c12 w^3 w^2).
# The Miller steps keep the native library's line scaling, which fixes each
# Miller value: the doubling step makes 6 Fp2 products, 6 squares and 2
# scalar products, the addition step 10, 4 and 2, each then a line product.
# G1's affine conversion: the inverse of z by the binary extended Euclid
# (its mean over random z, 534 halvings and 267 subtractions, each three
# passes over 12 words; then one product into Montgomery form), then z^-2
# (a squaring) and z^-3, x z^-2, y z^-3 (3 products).
INVERSE_OPS = (534 + 267) * 3 * 12 + FP_MUL_MADS
FP2_MUL_MADS = 3 * FP_MUL_MADS
FP2_SQR_MADS = FP2_SCALAR_MADS = 2 * FP_MUL_MADS
G1_DBL_MADS = 2 * FP_MUL_MADS + 5 * FP_SQR_MADS
G2_DBL_MADS = 2 * FP2_MUL_MADS + 5 * FP2_SQR_MADS
G2_MIXED_ADD_MADS = 7 * FP2_MUL_MADS + 4 * FP2_SQR_MADS
G2_ADD_MADS = 11 * FP2_MUL_MADS + 5 * FP2_SQR_MADS
FP12_MUL_MADS, FP12_SQR_MADS, FP12_LINE_MADS = (k * FP2_MUL_MADS for k in (18, 12, 13))
MILLER_DBL_MADS = 6 * FP2_MUL_MADS + 6 * FP2_SQR_MADS + 2 * FP2_SCALAR_MADS + FP12_LINE_MADS
MILLER_ADD_MADS = 10 * FP2_MUL_MADS + 4 * FP2_SQR_MADS + 2 * FP2_SCALAR_MADS + FP12_LINE_MADS
WINDOW_BLOCKS = 8  # the chain pipeline's default window
WINDOW_FIRST_SLOT = 2
# the aggregate of block 3's attestation 17 gets its neighbour's signature
WINDOW_TAMPERED_BLOCK, WINDOW_TAMPERED_ATTESTATION = 3, 17


def _scalar_mul_mads(scalars: list, dbl: int, add: int) -> int:
    """Multiply-adds of double-and-add over these scalars: from the top bit
    on, a doubling per lower bit and an addition per lower set bit (the
    steps before the top bit work on infinity and cost nothing)."""
    return sum((s.bit_length() - 1) * dbl + (bin(s).count("1") - 1) * add
               for s in scalars if s)


def _affine_ops() -> int:
    """The affine conversion of one lane: the inverse of z, then z^-2 (a
    squaring) and z^-3, x z^-2, y z^-3 (3 products)."""
    return INVERSE_OPS + FP_SQR_MADS + 3 * FP_MUL_MADS


def _miller_mads() -> int:
    from ethereum_consensus_tpu_torch.ops.pairing import BLS_X_ABS

    below_top = BLS_X_ABS.bit_length() - 1
    return (below_top * (FP12_SQR_MADS + MILLER_DBL_MADS)
            + (bin(BLS_X_ABS).count("1") - 1) * MILLER_ADD_MADS)


def g1_mul_affine_bound_ms(scalars: list) -> tuple[float, str]:
    mads = (_scalar_mul_mads(scalars, G1_DBL_MADS, G1_MIXED_ADD_MADS)
            + len(scalars) * _affine_ops())
    return _bound(mads, len(scalars) * (96 + 16 + 96))


def g2_mul_sum_bound_ms(scalars: list) -> tuple[float, str]:
    live = sum(1 for s in scalars if s)
    mads = (_scalar_mul_mads(scalars, G2_DBL_MADS, G2_MIXED_ADD_MADS)
            + max(live - 1, 0) * G2_ADD_MADS)
    return _bound(mads, len(scalars) * (192 + 16) + 288)


def miller_loop_bound_ms(n: int) -> tuple[float, str]:
    return _bound(n * _miller_mads(), n * (96 + 192 + 576))


def fp12_product_bound_ms(n: int) -> tuple[float, str]:
    return _bound((n - 1) * FP12_MUL_MADS, 576 * (n + 1))


def _timed_once(fn) -> tuple:
    """(result, CUDA-event milliseconds) of one call of ``fn``."""
    box: list = []
    ms = _cuda_ms(lambda: box.append(fn()), reps=1, warmup=0)
    return box[0], ms


def _pairing_batch(n: int, seed: int) -> dict:
    """n signed sets of one key each, from a seed: raw affine keys, message
    points and signatures, the compressed signatures and the blinders."""
    from ethereum_consensus_tpu_torch.crypto import bls
    from ethereum_consensus_tpu_torch.crypto.fields import R
    from ethereum_consensus_tpu_torch.crypto.hash_to_curve import ETH_DST
    from ethereum_consensus_tpu_torch.native import bls as native_bls

    rng = np.random.default_rng(seed)
    out = {"pk": [], "h": [], "sig": [], "sig96": [], "msg": []}
    for _ in range(n):
        sk = bls.SecretKey(int.from_bytes(rng.bytes(32), "big") % (R - 1) + 1)
        msg = rng.bytes(32)
        sig96 = sk.sign(msg).to_bytes()
        out["pk"].append(sk.public_key().raw_uncompressed())
        out["sig"].append(native_bls.g2_decompress(sig96, True)[1])
        out["h"].append(native_bls.g2_decompress(
            native_bls.hash_to_g2_compressed(msg, ETH_DST), False)[1])
        out["sig96"].append(sig96)
        out["msg"].append(msg)
    out["scalars"] = [int.from_bytes(rng.bytes(16), "big") | 1 for _ in range(n)]
    return out


def _max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


# the u64 build's crew kernels (csrc/pairing_lanes.h)
PAIRING_CREW_KERNELS = ("g1_mul_affine_kernel", "miller_loop_kernel", "g2_mul_lanes_kernel",
                        "g2_fold_kernel", "fp12_fold_kernel")


def _ptxas_summary(library: str, kernel: str) -> dict:
    """Registers, stack frame, spills and shared memory of one kernel from
    its library's ``-Xptxas -v`` lines."""
    import re

    from ethereum_consensus_tpu_torch import _kernels

    out, inside = {}, False
    for line in _kernels.build_log(library).splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            inside = kernel in line
        elif inside:
            for key, pattern in (("stack_frame", r"(\d+) bytes stack frame"),
                                 ("spill_stores", r"(\d+) bytes spill stores"),
                                 ("spill_loads", r"(\d+) bytes spill loads"),
                                 ("registers", r"Used (\d+) registers"),
                                 ("smem", r"(\d+) bytes smem")):
                match = re.search(pattern, line)
                if match:
                    out[key] = int(match.group(1))
    return out


def phase_pairing() -> dict:
    """The four B7 kernels against their plain versions on the card,
    bit-exact, at n in PAIRING_CHECK_NS on a seeded batch of signed sets;
    the Miller values of every lane against the native miller_loop_raw; the
    528-set verdict against the native batch verification, and one tampered
    set rejected by both. The window's Miller launch, the 528 lanes and the
    extra pair (-G, S) as lane 528, against the native Miller values, and
    its product against the plain one. CUDA-event times at the window's
    shapes (529 lanes for the Miller loop and the product, 528 for the
    blinders), and at one lane (two values for the product: one product)
    for each kernel (one lane's latency)."""
    from ethereum_consensus_tpu_torch.crypto.hash_to_curve import ETH_DST
    from ethereum_consensus_tpu_torch.native import bls as native_bls
    from ethereum_consensus_tpu_torch.ops import fq, pairing

    n_max = max(PAIRING_CHECK_NS)
    t0 = time.perf_counter()
    batch = _pairing_batch(n_max, seed=381)
    make_s = time.perf_counter() - t0
    scalars = batch["scalars"]
    words = pairing.scalar_words(scalars, "cuda")
    pk = torch.stack(pairing.g1_affine_from_raw(batch["pk"], "cuda"), dim=1).contiguous()
    sig_xy = pairing.g2_affine_from_raw(batch["sig"], "cuda")
    sig = torch.stack(sig_xy, dim=1).contiguous()
    xq, yq = (v.contiguous() for v in pairing.g2_affine_from_raw(batch["h"], "cuda"))

    # the plain versions: each lane-wise one runs once over all the lanes it
    # is held against (the Miller loop over the first 64)
    plain_pk, g1_plain_ms = _timed_once(lambda: pairing.g1_mul_affine_plain(pk, words))
    plain_sig_lanes = pairing.g2_mul_batched(sig_xy, scalars)
    xp, yp = plain_pk[:, 0].contiguous(), plain_pk[:, 1].contiguous()
    lanes = PAIRING_PLAIN_MILLER_LANES
    plain_miller, miller_plain_ms = _timed_once(
        lambda: pairing.miller_loop_plain(xp[:lanes], yp[:lanes], xq[:lanes], yq[:lanes]))
    # the native Miller value of every lane, on the blinded keys
    pk_ints = fq.to_ints(plain_pk)
    native_f = []
    for i in range(n_max):
        g1_raw = b"".join(v.to_bytes(48, "big") for v in pk_ints[2 * i : 2 * i + 2])
        native = native_bls.miller_loop_raw(g1_raw, batch["h"][i])
        native_f += [int.from_bytes(native[48 * k : 48 * (k + 1)], "big") for k in range(12)]
    errs = {"g1_mul_affine": 0, "g2_mul_sum": 0, "miller_loop": 0, "fp12_product": 0,
            "g2_sum_points": 0}
    native_ok = True
    u64_out = {}
    for n in PAIRING_CHECK_NS:
        got_pk = pairing.g1_mul_affine(pk[:n], words[:n])
        got_sum = pairing.g2_mul_sum(sig[:n], words[:n])
        got_f = pairing.miller_loop(xp[:n], yp[:n], xq[:n], yq[:n])
        got_prod = pairing.fp12_product(got_f)
        torch.cuda.synchronize()
        u64_out[n] = (got_pk, got_sum, got_f, got_prod)
        plain_prod = pairing.fp12_product_plain(got_f)
        plain_sum = pairing.g2_sum_points_plain(plain_sig_lanes[:n])
        step = {
            "g1_mul_affine": _max_err(got_pk, plain_pk[:n]),
            "g2_mul_sum": _max_err(got_sum, plain_sum),
            # g2_mul_sum's fold alone (g2_sum_launch), over the plain lanes
            "g2_sum_points": _max_err(pairing.g2_sum_points_cuda(
                plain_sig_lanes[:n].contiguous()), plain_sum),
            "miller_loop": _max_err(got_f[:lanes], plain_miller[:n]),
            "fp12_product": _max_err(got_prod, plain_prod),
        }
        native_ok &= fq.to_ints(got_f) == native_f[: 12 * n]
        print(f"pairing n={n}: max_abs_err vs plain {step}; the Miller values of all "
              f"{n} lanes equal native {native_ok}")
        for name, err in step.items():
            errs[name] = max(errs[name], err)
    if any(errs.values()) or not native_ok:
        sys.exit(f"chip_smoke: a pairing kernel disagrees: {errs}, native {native_ok}")

    sets = [([p], m, s) for p, m, s in zip(batch["pk"], batch["msg"], batch["sig96"])]
    blinders = [s.to_bytes(16, "big") for s in scalars]
    bad_sig, bad_sig96 = list(batch["sig"]), list(batch["sig96"])
    bad_sig[PAIRING_TAMPERED_SET] = bad_sig[PAIRING_TAMPERED_SET + 1]
    bad_sig96[PAIRING_TAMPERED_SET] = bad_sig96[PAIRING_TAMPERED_SET + 1]
    bad_sets = [([p], m, s) for p, m, s in zip(batch["pk"], batch["msg"], bad_sig96)]
    verdicts = {
        "device": pairing.batch_verify_device(batch["pk"], batch["h"], batch["sig"], scalars),
        "native": native_bls.batch_verify_raw(sets, ETH_DST, blinders),
        "device_tampered": pairing.batch_verify_device(batch["pk"], batch["h"], bad_sig, scalars),
        "native_tampered": native_bls.batch_verify_raw(bad_sets, ETH_DST, blinders),
    }
    print(f"pairing verdicts at {n_max} sets: {verdicts}")
    if verdicts != {"device": True, "native": True, "device_tampered": False,
                    "native_tampered": False}:
        sys.exit("chip_smoke: the device batch verdict disagrees with the native one")

    # the window's Miller launch (batch_verify_device): the 528 lanes, then
    # the extra pair (-G, S) at lane 528, S the G2 sum of the blinded
    # signatures
    s_raw, s_inf = pairing._g2_point_to_raw(u64_out[n_max][1])
    if s_inf:
        sys.exit("chip_smoke: the blinded signatures sum to infinity")
    extra = pairing._extra_pair(s_raw, "cuda")
    wide = tuple(torch.cat([v, e]).contiguous() for v, e in zip((xp, yp, xq, yq), extra))
    f_wide = pairing.miller_loop(*wide)
    prod_wide = pairing.fp12_product(f_wide)
    torch.cuda.synchronize()
    native_extra = native_bls.miller_loop_raw(pairing._neg_g1_generator_raw(), s_raw)
    native_extra_f = [int.from_bytes(native_extra[48 * k : 48 * (k + 1)], "big")
                      for k in range(12)]
    wide_native_ok = fq.to_ints(f_wide) == native_f + native_extra_f
    plain_prod_wide, prod_plain_ms = _timed_once(lambda: pairing.fp12_product_plain(f_wide))
    wide_errs = {"miller_loop": _max_err(f_wide[n_max:], pairing.miller_loop_plain(*extra)),
                 "fp12_product": _max_err(prod_wide, plain_prod_wide)}
    print(f"pairing window launch ({n_max} lanes and the extra pair): max_abs_err vs plain "
          f"{wide_errs}; the Miller values of all {n_max + 1} lanes equal native "
          f"{wide_native_ok}")
    if any(wide_errs.values()) or not wide_native_ok:
        sys.exit(f"chip_smoke: the window's Miller launch disagrees: {wide_errs}, "
                 f"native {wide_native_ok}")
    for name, err in wide_errs.items():
        errs[name] = max(errs[name], err)

    # the launches alone, at the window's shapes
    timings = {
        "g1_mul_affine": (_cuda_ms(lambda: pairing.g1_mul_affine_cuda(pk, words), reps=5),
                          g1_plain_ms, g1_mul_affine_bound_ms(scalars)),
        "g2_mul_sum": (_cuda_ms(lambda: pairing.g2_mul_sum_cuda(sig, words), reps=5),
                       _timed_once(lambda: pairing.g2_mul_sum_plain(sig, words))[1],
                       g2_mul_sum_bound_ms(scalars)),
        "miller_loop": (_cuda_ms(lambda: pairing.miller_loop_cuda(*wide), reps=3),
                        miller_plain_ms, miller_loop_bound_ms(n_max + 1)),
        "fp12_product": (_cuda_ms(lambda: pairing.fp12_product_cuda(f_wide), reps=10),
                         prod_plain_ms, fp12_product_bound_ms(n_max + 1)),
    }
    # one lane: the latency of a lane's schedule (the product: one product)
    one_lane_ms = {
        "g1_mul_affine": _cuda_ms(lambda: pairing.g1_mul_affine_cuda(pk[:1], words[:1]), reps=5),
        "g2_mul_sum": _cuda_ms(lambda: pairing.g2_mul_sum_cuda(sig[:1], words[:1]), reps=5),
        "miller_loop": _cuda_ms(lambda: pairing.miller_loop_cuda(xp[:1], yp[:1], xq[:1], yq[:1]),
                                reps=5),
        "fp12_product": _cuda_ms(lambda: pairing.fp12_product_cuda(f_wide[:2]), reps=10),
    }
    # blinder 1 leaves no doubling: the lane's inversion and affine steps
    one_word = pairing.scalar_words([1], "cuda")
    inverse_ms = _cuda_ms(lambda: pairing.g1_mul_affine_cuda(pk[:1], one_word), reps=5)
    print(f"pairing g1_mul_affine at 1 lane, blinder 1 (the inversion and the affine steps "
          f"alone): {inverse_ms:.4f} ms")
    # the G2 sum's fold launches alone, over the 528 lanes' points
    lanes_jac = plain_sig_lanes.contiguous()
    fold_ms = _cuda_ms(lambda: pairing.g2_sum_points_cuda(lanes_jac), reps=5)
    print(f"pairing g2_sum_points (the fold alone): {fold_ms:.4f} ms at {n_max} points")
    crews = {kernel: _ptxas_summary("pairing", kernel) for kernel in PAIRING_CREW_KERNELS}
    for kernel, summary in crews.items():
        print(f"pairing ptxas {kernel}: {summary}")
    report = {"make_s": make_s, "verdicts": verdicts, "one_lane_ms": one_lane_ms,
              "g1_blinder_1_ms": inverse_ms, "fold_ms": fold_ms, "ptxas": crews}
    for name, (ms, plain_ms, (bound, bound_by)) in timings.items():
        at = n_max + 1 if name in ("miller_loop", "fp12_product") else n_max
        plain_at = lanes if name == "miller_loop" else at
        one = (f"; {one_lane_ms[name]:.4f} ms at {2 if name == 'fp12_product' else 1} "
               f"{'values' if name == 'fp12_product' else 'lane'}")
        print(f"pairing {name}: {ms:.4f} ms at {at} lanes{one} (bound {bound:.4f} ms by "
              f"{bound_by}); plain {plain_ms:.3f} ms at {plain_at} lanes")
        report[name] = {"ms": ms, "lanes": at, "plain_ms": plain_ms, "plain_lanes": plain_at,
                        "bound_ms": bound, "bound_by": bound_by, "max_abs_err": errs[name]}
    print(f"pairing: batch made in {make_s:.1f} s; kernel SASS instructions "
          f"{_sass_instructions('pairing')}")
    report["mxu"] = _pairing_mxu(pk, words, sig, xp, yp, xq, yq, u64_out, native_f,
                                 (wide, f_wide, prod_wide), report)
    return report


def _pairing_mxu(pk, words, sig, xp, yp, xq, yq, u64_out: dict, native_f: list,
                 window: tuple, u64: dict) -> dict:
    """The four B7 kernels' mxu build (EC_PAIRING_MULT=mxu) on the same
    lanes: bit-exact against the u64 kernels at every n of
    PAIRING_CHECK_NS and on the window's Miller launch (``window``: its 529
    lanes, the u64 Miller values and their product), against the plain
    versions under mxu at n = 3 (the plain tower on the card takes seconds
    a lane), the Miller values of all lanes against the native ones;
    CUDA-event ms at the window's shapes, and the plain versions' ms under
    mxu at 3 lanes, from that one call."""
    from ethereum_consensus_tpu_torch.ops import fq, fq8, pairing

    names = ("g1_mul_affine", "g2_mul_sum", "miller_loop", "fp12_product")
    errs = {name: 0 for name in names}
    plain_errs = {name: 0 for name in names}
    plain_n = 3
    p3 = slice(0, plain_n)
    fq8.set_multiplier("mxu")
    try:
        for n in PAIRING_CHECK_NS:
            got_f = pairing.miller_loop(xp[:n], yp[:n], xq[:n], yq[:n])
            got = (pairing.g1_mul_affine(pk[:n], words[:n]), pairing.g2_mul_sum(sig[:n], words[:n]),
                   got_f, pairing.fp12_product(got_f))
            torch.cuda.synchronize()
            for name, a, b in zip(names, got, u64_out[n]):
                errs[name] = max(errs[name], _max_err(a, b))
            native_ok = fq.to_ints(got_f) == native_f[: 12 * n]
            if n == plain_n:
                # each plain version once, its time that call's
                plain, plain_ms = zip(
                    _timed_once(lambda: pairing.g1_mul_affine_plain(pk[p3], words[p3])),
                    _timed_once(lambda: pairing.g2_mul_sum_plain(sig[p3], words[p3])),
                    _timed_once(lambda: pairing.miller_loop_plain(xp[p3], yp[p3], xq[p3],
                                                                  yq[p3])),
                    _timed_once(lambda: pairing.fp12_product_plain(got_f)))
                for name, a, b in zip(names, got, plain):
                    plain_errs[name] = max(plain_errs[name], _max_err(a, b))
            print(f"pairing mxu n={n}: max_abs_err vs u64 {errs}, vs plain under mxu (n = "
                  f"{plain_n}) {plain_errs}; the Miller values of all {n} lanes equal native "
                  f"{native_ok}")
            if any(errs.values()) or any(plain_errs.values()) or not native_ok:
                sys.exit(f"chip_smoke: a pairing kernel's mxu build disagrees at n={n}")
        wide, f_wide, prod_wide = window
        got_f = pairing.miller_loop(*wide)
        errs["miller_loop"] = max(errs["miller_loop"], _max_err(got_f, f_wide))
        errs["fp12_product"] = max(errs["fp12_product"],
                                   _max_err(pairing.fp12_product(got_f), prod_wide))
        print(f"pairing mxu window launch ({len(f_wide)} lanes): max_abs_err vs u64 {errs}")
        if any(errs.values()):
            sys.exit("chip_smoke: the mxu build disagrees on the window's Miller launch")
        # each kernel at the window's shape
        timings = {
            "g1_mul_affine": (_cuda_ms(lambda: pairing.g1_mul_affine_cuda(pk, words), reps=5),
                              plain_ms[0]),
            "g2_mul_sum": (_cuda_ms(lambda: pairing.g2_mul_sum_cuda(sig, words), reps=5),
                           plain_ms[1]),
            "miller_loop": (_cuda_ms(lambda: pairing.miller_loop_cuda(*wide), reps=3),
                            plain_ms[2]),
            "fp12_product": (_cuda_ms(lambda: pairing.fp12_product_cuda(f_wide), reps=10),
                             plain_ms[3]),
        }
    finally:
        fq8.set_multiplier("u64")
    report = {}
    for name, (ms, plain_ms) in timings.items():
        row = u64[name]
        print(f"pairing {name} mxu build: {ms:.4f} ms at {row['lanes']} lanes (u64 "
              f"{row['ms']:.4f}; bound {row['bound_ms']:.4f} ms by {row['bound_by']}); "
              f"plain under mxu {plain_ms:.3f} ms at {plain_n} lanes")
        report[name] = {"ms": ms, "lanes": row["lanes"], "plain_ms": plain_ms,
                        "plain_lanes": plain_n, "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "max_abs_err": max(errs[name], plain_errs[name])}
    print(f"pairing mxu build: kernel SASS instructions {_sass_instructions('pairing_mxu')}")
    return report


def build_window(registry: dict) -> dict:
    """WINDOW_BLOCKS signed blocks at consecutive slots from
    WINDOW_FIRST_SLOT on the registry's 2^20-validator phase0 state; block
    k carries the 64 full aggregates of slot k (so no validator attests
    twice) and is built as make_block builds one. The keys of those slots'
    attesters and of the blocks' proposers are made real first. Returns the
    pre-state's bytes and the blocks."""
    from ethereum_consensus_tpu_torch import ops
    from ethereum_consensus_tpu_torch.crypto import bls
    from ethereum_consensus_tpu_torch.crypto.fields import R
    from ethereum_consensus_tpu_torch.domains import DomainType
    from ethereum_consensus_tpu_torch.models.phase0 import block_processing, build
    from ethereum_consensus_tpu_torch.models.phase0 import helpers as h
    from ethereum_consensus_tpu_torch.models.phase0 import slot_processing
    from ethereum_consensus_tpu_torch.models.phase0.containers import BeaconBlockHeader
    from ethereum_consensus_tpu_torch.models.signature_batch import collect_signatures
    from ethereum_consensus_tpu_torch.signing import compute_signing_root
    from ethereum_consensus_tpu_torch.ssz import uint64

    ops.uninstall()
    ctx = registry["ctx"]
    ns = build(ctx.preset)
    t0 = time.perf_counter()
    state = _setup_state(registry)
    read_s = time.perf_counter() - t0
    # committees and proposers of epoch 0 depend on its seeds and balances
    # only, which the window's blocks leave as they are
    t0 = time.perf_counter()
    per_slot = h.get_committee_count_per_slot(state, 0, ctx)
    committees = [[h.get_beacon_committee(state, slot, index, ctx) for index in range(per_slot)]
                  for slot in range(WINDOW_BLOCKS)]
    active = h.get_active_validator_indices(state, 0)
    proposer_seed = h.get_seed(state, 0, DomainType.BEACON_PROPOSER, ctx)
    slots = range(WINDOW_FIRST_SLOT, WINDOW_FIRST_SLOT + WINDOW_BLOCKS)
    proposers = [h.compute_proposer_index(
        state, active, hashlib.sha256(proposer_seed + slot.to_bytes(8, "little")).digest(), ctx)
        for slot in slots]
    known: dict = {}
    keys = _realize_keys(state, [i for c in committees for cc in c for i in cc] + proposers,
                         known)
    keys_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pre = type(state).serialize(state)
    serialize_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    blocks = []
    for k, slot in enumerate(slots):
        slot_processing.process_slots(state, slot, ctx)
        if h.get_beacon_proposer_index(state, ctx) != proposers[k]:
            sys.exit(f"chip_smoke: the planned proposer of slot {slot} is not the state's")
        attester_domain = h.get_domain(state, DomainType.BEACON_ATTESTER, 0, ctx)
        target = ns.Checkpoint(epoch=0, root=h.get_block_root_at_slot(state, 0))
        attestations = []
        for index, committee in enumerate(committees[k]):
            att_data = ns.AttestationData(
                slot=k, index=index, beacon_block_root=h.get_block_root_at_slot(state, k),
                source=state.current_justified_checkpoint.copy(), target=target.copy(),
            )
            root = compute_signing_root(ns.AttestationData, att_data, attester_domain)
            summed = bls.SecretKey(sum(i + 1 for i in committee) % R)
            attestations.append(ns.Attestation(
                aggregation_bits=[True] * len(committee), data=att_data,
                signature=summed.sign(root).to_bytes(),
            ))
        proposer_key = bls.SecretKey(proposers[k] + 1)
        randao_root = compute_signing_root(
            uint64, 0, h.get_domain(state, DomainType.RANDAO, 0, ctx))
        block = ns.BeaconBlock(
            slot=slot, proposer_index=proposers[k],
            parent_root=BeaconBlockHeader.hash_tree_root(state.latest_block_header),
            body=ns.BeaconBlockBody(
                randao_reveal=proposer_key.sign(randao_root).to_bytes(),
                eth1_data=state.eth1_data.copy(), attestations=attestations,
            ),
        )
        # the signatures are checked when the window is verified, not here
        with collect_signatures():
            block_processing.process_block(state, block, ctx)
        block.state_root = type(state).hash_tree_root(state)
        proposer_domain = h.get_domain(state, DomainType.BEACON_PROPOSER, None, ctx)
        root = compute_signing_root(ns.BeaconBlock, block, proposer_domain)
        blocks.append(ns.SignedBeaconBlock(message=block,
                                           signature=proposer_key.sign(root).to_bytes()))
    blocks_s = time.perf_counter() - t0
    del state
    # the window phase's loop runs with the collector on: a full collection
    # now counts the set-up's survivors as long-lived
    gc.collect()
    print(f"window: {WINDOW_BLOCKS} blocks at slots {slots.start}..{slots.stop - 1}; state "
          f"copied {read_s:.1f} s; committees, proposers and {keys} real keys {keys_s:.1f} s; "
          f"serialize {serialize_s:.1f} s; blocks {blocks_s:.1f} s")
    return {"pre": pre, "ctx": ctx, "blocks": blocks, "keys": keys, "known": known,
            "per_slot": per_slot,
            "setup_s": {"read": read_s, "keys": keys_s, "serialize": serialize_s,
                        "blocks": blocks_s}}


def _verify_route(sets: list, installed: bool, multiplier: str = "u64") -> dict:
    """verify_signature_sets on one route, with host timers on its parts
    and CUDA events on every kernel launch of the device route (each B6 and
    B7 kernel under its name, "_mxu" added on the mxu multiplier)."""
    from ethereum_consensus_tpu_torch import ops
    from ethereum_consensus_tpu_torch.crypto import bls
    from ethereum_consensus_tpu_torch.native import bls as native_bls
    from ethereum_consensus_tpu_torch.ops import fq8, g1, pairing

    ops.uninstall()
    if installed:
        ops.install(device="cuda")
    fq8.set_multiplier(multiplier)
    suffix = "_mxu" if multiplier == "mxu" else ""
    events: list = []
    parts: dict = {}
    try:
        with contextlib.ExitStack() as stack:
            # B6's part of the device route: aggregate_pubkey_sets_device's
            # host marshalling (sets_to_csr), its call of the wrapper (the
            # offsets check waits for the upload), and the affine conversion
            # (waits for the kernel, then one inversion a set); the upload is
            # what the aggregation's wall leaves
            for module, name, key in (
                    (native_bls, "batch_verify_raw", "native_batch"),
                    (g1, "aggregate_pubkey_sets_device", "g1_aggregation"),
                    (g1, "sets_to_csr", "g1_sets_to_csr"),
                    (g1, "g1_sum_sets", "g1_sum_sets_call"),
                    (g1, "jacobian_to_affine", "g1_jacobian_to_affine"),
                    (native_bls, "hash_to_g2_compressed", "hash_to_g2"),
                    (pairing, "batch_verify_device", "batch_verify_device"),
                    (pairing, "finalize_verdict", "finalize_verdict"),
                    (pairing, "_final_exp_is_one", "final_exp")):
                stack.enter_context(_patched(module, name, _host_timer(parts, key)))
            if installed:
                for module, name, key in (
                        (g1, "_launch", "g1_sum_sets"),
                        (pairing, "g1_mul_affine_cuda", "g1_mul_affine"),
                        (pairing, "g2_mul_sum_cuda", "g2_mul_sum"),
                        (pairing, "miller_loop_cuda", "miller_loop"),
                        (pairing, "fp12_product_cuda", "fp12_product")):
                    stack.enter_context(_patched(module, name, _event_timer(events, key + suffix)))
            _zero_launch_counts()
            t0 = time.perf_counter()
            verdicts = bls.verify_signature_sets(sets)
            if installed:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            route = bls.last_batch_route()
            launches = _launch_counts()
    finally:
        fq8.set_multiplier("u64")
        ops.uninstall()
    kernel_ms: dict = {}
    for name, start, end in events:
        kernel_ms[name] = kernel_ms.get(name, 0.0) + start.elapsed_time(end)
    # the host route launches nothing: its card idles throughout
    idle = 1.0 - sum(kernel_ms.values()) / (1e3 * seconds)
    return {"verdicts": verdicts, "s": seconds, "route": route, "launches": launches,
            "parts_s": parts, "kernel_ms_inside": kernel_ms, "idle_share": idle}


def _window_g1_sum(sets: list) -> dict:
    """B6 (the u64 build) alone at the window's shape: the device route's
    set sums, its two launches over the window's sets, limb for limb against
    the plain version and the mxu build; CUDA-event ms beside the bound of
    these keys."""
    from ethereum_consensus_tpu_torch.ops import fq8, g1

    raw_sets = [[pk.raw_uncompressed() for pk in s.public_keys] for s in sets]
    points, offsets = g1.sets_to_csr(raw_sets)
    points_d, offsets_d = points.cuda(), offsets.cuda()
    got = g1.g1_sum_sets(points_d, offsets_d)
    errs = {"vs plain": _max_err(got, g1.g1_sum_sets_plain(points_d, offsets_d))}
    fq8.set_multiplier("mxu")
    try:
        errs["mxu vs u64"] = _max_err(g1.g1_sum_sets(points_d, offsets_d), got)
        mxu_ms = _cuda_ms(lambda: g1._launch(points_d, offsets_d, len(sets)), reps=5)
    finally:
        fq8.set_multiplier("u64")
    ms = _cuda_ms(lambda: g1._launch(points_d, offsets_d, len(sets)), reps=5)
    keys = sum(len(s) for s in raw_sets)
    bound, bound_by = g1_bound_ms([sum(1 for r in s if any(r)) for s in raw_sets], keys)
    print(f"window g1_sum_sets (u64) alone: {ms:.4f} ms at {len(sets)} sets, {keys} keys "
          f"(bound {bound:.4f} ms by {bound_by}); max_abs_err {errs}; its mxu build "
          f"{mxu_ms:.4f} ms")
    if any(errs.values()):
        sys.exit(f"chip_smoke: the window's G1 set sums disagree: {errs}")
    return {"ms": ms, "sets": len(sets), "keys": keys, "bound_ms": bound, "bound_by": bound_by,
            "max_abs_err": errs, "mxu_ms": mxu_ms}


def _block_g1_sum(cell: str, sets: list) -> dict:
    """B6 (the u64 build) alone at a block's signature sets, as its batch
    had them on the cell's first route: its two launches limb for limb
    against the plain version, CUDA-event ms beside the bound of these
    keys."""
    from ethereum_consensus_tpu_torch.ops import g1

    if not sets:
        sys.exit(f"chip_smoke: the {cell} block's signature sets were not captured")
    raw_sets = [[pk.raw_uncompressed() for pk in s.public_keys] for s in sets]
    points, offsets = g1.sets_to_csr(raw_sets)
    points_d, offsets_d = points.cuda(), offsets.cuda()
    err = _max_err(g1.g1_sum_sets(points_d, offsets_d), g1.g1_sum_sets_plain(points_d, offsets_d))
    ms = _cuda_ms(lambda: g1._launch(points_d, offsets_d, len(sets)), reps=10)
    keys = sum(len(s) for s in raw_sets)
    live = [sum(1 for r in s if any(r)) for s in raw_sets]
    bound, bound_by = g1_bound_ms(live, keys)
    sizes = sorted((len(s) for s in raw_sets), reverse=True)
    print(f"{cell} g1_sum_sets (u64) alone: {ms:.4f} ms at the block's {len(sets)} sets, {keys} "
          f"keys (the largest {sizes[:3]}; bound {bound:.4f} ms by {bound_by}, "
          f"{100 * bound / ms:.2f}% of it); max_abs_err vs plain {err}")
    if err:
        sys.exit(f"chip_smoke: the {cell} block's G1 set sums disagree with the plain version")
    return {"ms": ms, "sets": len(sets), "keys": keys, "largest": sizes[:3], "bound_ms": bound,
            "bound_by": bound_by, "max_abs_err": err}


def phase_window(registry: dict) -> dict:
    """A window of WINDOW_BLOCKS signed blocks on the 2^20-validator phase0
    state applied through Executor.apply_block_with_validation under
    defer_flushes after ops.install(device="cuda") (its launches kept: the
    pipeline phase's stage A makes the same), then its 528 sets verified
    with one verify_signature_sets call on the host route and after
    ops.install(device="cuda") (the device pairing at the default 512
    sets): the same verdicts, and the same blame for a copy with one
    aggregate's signature replaced by its neighbour's."""
    from ethereum_consensus_tpu_torch import ops
    from ethereum_consensus_tpu_torch.crypto import bls
    from ethereum_consensus_tpu_torch.executor import Executor, Validation
    from ethereum_consensus_tpu_torch.models.phase0 import build
    from ethereum_consensus_tpu_torch.models.signature_batch import SignatureBatch, defer_flushes

    with _collector_paused():
        setup = build_window(registry)
    ctx = setup["ctx"]
    t0 = time.perf_counter()
    state = build(ctx.preset).BeaconState.deserialize(setup["pre"])
    read_s = time.perf_counter() - t0
    sink = SignatureBatch()
    executor = Executor(state, ctx)
    ops.uninstall()  # a cold shuffle cache: the committees on the card
    ops.install(device="cuda")
    _zero_launch_counts()
    try:
        t0 = time.perf_counter()
        with defer_flushes(sink):
            for signed in setup["blocks"]:
                executor.apply_block_with_validation(signed, Validation.ENABLED)
        torch.cuda.synchronize()
        apply_s = time.perf_counter() - t0
        apply_launches = {k: v for k, v in _launch_counts().items() if v}
    finally:
        ops.uninstall()
    sets = list(sink.sets)
    n_keys = sum(len(s.public_keys) for s in sets)
    # both routes read the same PublicKey objects: decompress them once
    t0 = time.perf_counter()
    bls.warm_raw_keys(pk for s in sets for pk in s.public_keys)
    warm_s = time.perf_counter() - t0
    root = type(executor.state.data).hash_tree_root(executor.state.data).hex()
    print(f"window: read {read_s:.1f} s; {WINDOW_BLOCKS} blocks applied under defer_flushes "
          f"on the device path in {apply_s:.3f} s (launches {apply_launches}), post-state root "
          f"{root}; {len(sets)} sets, {n_keys} keys, decompressed in {warm_s:.1f} s")
    # each block: the proposer, the randao reveal, then its aggregates
    per_block = setup["per_slot"] + 2
    if len(sets) != WINDOW_BLOCKS * per_block:
        sys.exit(f"chip_smoke: the window holds {len(sets)} sets, not {WINDOW_BLOCKS * per_block}")
    t = (WINDOW_TAMPERED_BLOCK * per_block + 2
         + min(WINDOW_TAMPERED_ATTESTATION, setup["per_slot"] - 2))
    tampered = list(sets)
    tampered[t] = bls.SignatureSet(sets[t].public_keys, sets[t].message, sets[t + 1].signature)
    routes, blame = {}, {}
    for name, installed, multiplier in (("host", False, "u64"), ("device", True, "u64"),
                                        ("device_mxu", True, "mxu")):
        result = _verify_route(sets, installed, multiplier)
        bad = _verify_route(tampered, installed, multiplier)
        blame[name] = bad["verdicts"]
        result["blame_s"] = bad["s"]
        result["sets_per_s"] = len(sets) / result["s"]
        routes[name] = result
        print(f"window {name}: {len(sets)} sets in {result['s']:.3f} s "
              f"({result['sets_per_s']:.1f} sets/s) {_rounded(result['parts_s'])}, route "
              f"{result['route']!r}, all true {all(result['verdicts'])}; launches "
              f"{result['launches']}"
              + (f"; kernel ms inside {_rounded(result['kernel_ms_inside'], 4)}" if installed
                 else "") + f"; idle share {result['idle_share']:.6f}"
              + f"; tampered copy: false at {[i for i, v in enumerate(bad['verdicts']) if not v]}"
              f" in {bad['s']:.3f} s, route {bad['route']!r}")
    host, device, mxu = routes["host"], routes["device"], routes["device_mxu"]
    if not all(all(r["verdicts"]) for r in routes.values()):
        sys.exit("chip_smoke: a set of the window did not verify")
    if (host["route"], device["route"], mxu["route"]) != ("host", "device", "device"):
        sys.exit(f"chip_smoke: the routes ran {host['route']!r}, {device['route']!r} and "
                 f"{mxu['route']!r}")
    if (blame["host"] != blame["device"] or blame["host"] != blame["device_mxu"]
            or [i for i, v in enumerate(blame["host"]) if not v] != [t]):
        sys.exit("chip_smoke: the tampered window's blame differs between the routes")
    # grid launches: one Miller launch over the window's lanes and the extra
    # pair (lane 528); the G2 lanes, then two folds that take them to 9 block
    # partials, then to one; the Fq12 product's two folds (u64: 17 blocks of
    # 32 values, then one; mxu: 9 blocks of 64, then one)
    want = {"g1_sum_sets": G1_SUM_LAUNCHES, "g1_mul_affine": 1, "g2_mul_sum": 3,
            "miller_loop": 1, "fp12_product": 2}
    want_mxu = {f"{k}_mxu": v for k, v in want.items()}
    want_mxu["g1_sum_sets_mxu"] = 1  # the mxu build folds in its one launch
    if (any(device["launches"][k] != v for k, v in want.items())
            or any(mxu["launches"][k] != v for k, v in want_mxu.items())
            or any(host["launches"][k] or host["launches"][m] or device["launches"][m]
                   or mxu["launches"][k] for k, m in zip(want, want_mxu))):
        sys.exit(f"chip_smoke: the window's launches are off: device {device['launches']}, "
                 f"mxu {mxu['launches']}, host {host['launches']}")
    b6 = _window_g1_sum(sets)
    return {"blocks": WINDOW_BLOCKS, "sets": len(sets), "keys": n_keys,
            "real_keys": setup["keys"], "setup_s": setup["setup_s"], "read_s": read_s,
            "apply_s": apply_s, "apply_launches": apply_launches, "warm_s": warm_s,
            "root": root, "tampered_set": t, "per_block": per_block,
            # for the pipeline phase, which streams the same blocks
            "pre": setup["pre"], "ctx": ctx, "signed_blocks": setup["blocks"],
            "known": setup["known"],
            "routes": routes, "g1_sum_sets": b6,
            # for the mesh phase, which verifies them on ECT_MESH=1
            "signature_sets": sets, "tampered_sets": tampered, "blame": blame["host"]}


# --- the chain pipeline: Executor.stream over the window's blocks ------------

PIPELINE_POLICY = {"window_size": WINDOW_BLOCKS, "max_in_flight": 2, "verify_lanes": 1}
# the device route's grid launches for one window of 528 sets, all on the
# verifier's thread (lane 0's worker, named by crypto/bls._verify_pool)
PIPELINE_VERIFIER_KERNELS = {"g1_sum_sets": G1_SUM_LAUNCHES, "g1_mul_affine": 1,
                             "g2_mul_sum": 3, "miller_loop": 1, "fp12_product": 2}
PIPELINE_VERIFIER_THREAD = "bls-verify-0"
PIPELINE_FAULTS = ("worker_death", "transient", "retries", "verifier_error", "settle_timeout")


def _launch_threads(tally: dict):
    """Wrap telemetry.device.launch (which every kernel wrapper calls where
    it adds to its launch count) to tally each kernel's launches by the
    launching thread's name."""
    import threading

    lock = threading.Lock()

    def wrap(fn):
        def launch(kernel, count=1):
            name = threading.current_thread().name
            with lock:
                per = tally.setdefault(kernel, {})
                per[name] = per.get(name, 0) + count
            return fn(kernel, count)
        return launch
    return wrap


def _settled(bucket: dict, verdicts: list):
    """Wrap VerifyScheduler.settle_oldest: the submitter's wait in
    ``bucket["settle_s"]``, each window's verdicts appended to
    ``verdicts``."""
    def wrap(fn):
        def settle_oldest(self):
            t0 = time.perf_counter()
            try:
                window, got = fn(self)
            finally:
                bucket["settle_s"] = bucket.get("settle_s", 0.0) + time.perf_counter() - t0
            verdicts.append(got)
            return window, got
        return settle_oldest
    return wrap


def phase_pipeline(window: dict, registry: dict) -> dict:
    """The slice's main path: the window's blocks through Executor.stream
    (the chain pipeline) on the card. The clean stream (timed) reads the
    pre-state from SSZ, installs the device route at the default thresholds
    and streams the eight blocks as one window: the window phase's
    post-state root, one flush of 528 sets on the device route from the
    verifier's thread, the launch ledger equal to the counts, B1 and B4 as
    the window phase's loop launched them (the main thread), B6 and B7 as
    PIPELINE_VERIFIER_KERNELS (the verifier's thread). The tampered stream
    (untimed, from the pre-state read again) streams the blocks before
    block WINDOW_TAMPERED_BLOCK and that block with its proposer signature
    replaced by the block before's, one partial window:
    Executor.apply_block's error for that block, the committed state at the
    block before's state root, the pipeline broken, the window on the
    device route and its blame that block's proposer set alone. A HeadStore
    (serving/headstore.py) is attached to the tampered stream's commits and
    handed to the serve and pool phases in ``store``."""
    import threading

    from ethereum_consensus_tpu_torch import ops
    from ethereum_consensus_tpu_torch.error import Error
    from ethereum_consensus_tpu_torch.executor import Executor
    from ethereum_consensus_tpu_torch.models.phase0 import build
    from ethereum_consensus_tpu_torch.pipeline import (ChainPipeline, FlushPolicy,
                                                       PipelineBrokenError, scheduler)
    from ethereum_consensus_tpu_torch.serving import HeadStore
    from ethereum_consensus_tpu_torch.telemetry import device, flight, metrics

    ctx, blocks = window["ctx"], window["signed_blocks"]
    ns = build(ctx.preset)
    faults = {k: metrics.counter(f"pipeline.fault.{k}") for k in PIPELINE_FAULTS}
    faults_before = {k: c.value() for k, c in faults.items()}
    gc.collect()
    t0 = time.perf_counter()
    state = ns.BeaconState.deserialize(window["pre"])
    read_s = time.perf_counter() - t0

    # -- the clean stream, timed
    settle: dict = {}
    verdicts: list = []
    threads: dict = {}
    executor = Executor(state, ctx)
    ops.uninstall()
    ops.install(device="cuda")
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(_patched(scheduler.VerifyScheduler, "settle_oldest",
                                         _settled(settle, verdicts)))
            stack.enter_context(_patched(device, "launch", _launch_threads(threads)))
            recorder = flight.start()
            device.start()
            _zero_launch_counts()
            try:
                t0 = time.perf_counter()
                stats = executor.stream(blocks, policy=FlushPolicy(**PIPELINE_POLICY))
                torch.cuda.synchronize()
                stream_s = time.perf_counter() - t0
            finally:
                device.stop()
                flight.stop()
            launches = {k: v for k, v in _launch_counts().items() if v}
            ledger = device.OBSERVATORY.launches()
    finally:
        ops.uninstall()
    root = type(executor.state.data).hash_tree_root(executor.state.data).hex()
    lineage = recorder.records()
    recorder.clear()
    snap = stats.snapshot()
    faults_moved = {k: c.value() - faults_before[k] for k, c in faults.items()
                    if c.value() != faults_before[k]}
    want = dict(window["apply_launches"])
    for name, n in PIPELINE_VERIFIER_KERNELS.items():
        want[name] = want.get(name, 0) + n
    main = threading.main_thread().name
    on_verifier = {k: sum(n for t, n in threads.get(k, {}).items()
                          if t.startswith(PIPELINE_VERIFIER_THREAD)) for k in PIPELINE_VERIFIER_KERNELS}
    on_main = {k: threads.get(k, {}).get(main, 0) for k in window["apply_launches"]}
    verify_s = lineage[0].verify_s if lineage else None
    window_device_s = window["apply_s"] + window["routes"]["device"]["s"]
    print(f"pipeline: read {read_s:.1f} s; stream of "
          f"{len(blocks)} blocks {stream_s:.3f} s wall (the pipeline's own {snap['wall_s']:.3f} s "
          f"from the first submit); stage A busy {snap['stage_a_s']:.3f} s, stage B busy "
          f"{snap['stage_b_s']:.3f} s, the submitter's settle wait {settle.get('settle_s', 0.0):.3f}"
          f" s, the window's verify {verify_s} s; the window phase's loop and device "
          f"verification {window['apply_s']:.3f} + {window['routes']['device']['s']:.3f} = "
          f"{window_device_s:.3f} s beside the stream's {stream_s:.3f} s")
    print(f"pipeline: root {root} (window {window['root']}); flush sizes {snap['flush_sizes']}, "
          f"retries {snap['fault_retries']}, degraded {snap['degraded_flushes']}, rollbacks "
          f"{snap['rollbacks']}, faults moved {faults_moved}; lineage {len(lineage)} records, "
          f"routes {sorted({str(r.verify_route) for r in lineage})}, dispositions "
          f"{sorted({r.disposition for r in lineage})}")
    print(f"pipeline: launches {launches}, ledger {ledger}; by thread {threads}")
    if root != window["root"]:
        sys.exit(f"chip_smoke: the stream's root {root} is not the window's {window['root']}")
    n_sets = window["sets"]
    if (snap["flush_sizes"] != [n_sets] or snap["fault_retries"] or snap["degraded_flushes"]
            or snap["rollbacks"] or faults_moved or snap["blocks_committed"] != len(blocks)):
        sys.exit(f"chip_smoke: the stream was not one clean window of {n_sets} sets: {snap}, "
                 f"faults {faults_moved}")
    if (len(lineage) != len(blocks) or any(r.verify_route != "device" or r.flush_sets != n_sets
                                           or r.disposition != "committed" for r in lineage)):
        sys.exit("chip_smoke: the stream's window did not commit on the device route")
    if verdicts != [[True] * n_sets]:
        sys.exit("chip_smoke: the stream's window did not verify")
    if launches != want or ledger != launches:
        sys.exit(f"chip_smoke: the stream's launches are off: counts {launches}, ledger "
                 f"{ledger}, want {want}")
    if on_verifier != PIPELINE_VERIFIER_KERNELS or on_main != window["apply_launches"]:
        sys.exit(f"chip_smoke: B6 and B7 did not launch on the verifier's thread, or B1 and B4 "
                 f"not on the main thread: {threads}")
    del executor, state

    # -- the tampered stream, untimed
    bad = blocks[WINDOW_TAMPERED_BLOCK].copy()
    bad.signature = bytes(blocks[WINDOW_TAMPERED_BLOCK - 1].signature)
    # the blocks up to the tampered one: the pipeline's close flushes them
    # as one partial window (the blocks after it would be applied and
    # discarded, untimed work the check does not need)
    stream = blocks[:WINDOW_TAMPERED_BLOCK] + [bad]
    stream_sets = len(stream) * window["per_block"]
    bad_verdicts: list = []
    t_start = time.perf_counter()
    with _collector_paused():
        # made after the clean stream, so that it is not on the heap while
        # the clean stream is timed: the registry's state with the window's
        # keys, as build_window made the pre-state (the same bytes), whose
        # root costs less than a cold read's; one root first: the
        # pipeline's checkpoint copies carry its memo, so the stream and the
        # rollback's re-application run warm
        tampered_pre = _setup_state(registry)
        _realize_keys(tampered_pre, window["known"], window["known"])
        type(tampered_pre).hash_tree_root(tampered_pre)
        pre_s = time.perf_counter() - t_start
        tampered = Executor(tampered_pre, ctx)
        pipe = ChainPipeline(tampered, policy=FlushPolicy(**PIPELINE_POLICY))
        # the read plane's head store rides this stream: the engine copies
        # the window's post-state at dispatch and publishes only commits
        store = HeadStore().attach()
        # the partial window's sets (4 blocks' 264) on the device route too
        ops.install(device="cuda", pairing_min_sets=stream_sets)
        try:
            with _patched(scheduler.VerifyScheduler, "settle_oldest",
                          _settled({}, bad_verdicts)):
                recorder = flight.start()
                caught = None
                try:
                    for signed in stream:
                        pipe.submit(signed)
                    pipe.close()
                except Error as exc:
                    caught = exc
                finally:
                    flight.stop()
            refused = False
            try:
                pipe.submit(blocks[WINDOW_TAMPERED_BLOCK])
            except PipelineBrokenError:
                refused = True
            committed_root = type(tampered.state.data).hash_tree_root(tampered.state.data)
            # what Executor.apply_block raises for the tampered block on the
            # committed state (the broken pipeline's state, not used after)
            probe = Executor(tampered.state, ctx)
            expected = None
            try:
                probe.apply_block(bad)
            except Error as exc:
                expected = exc
        finally:
            ops.uninstall()
            store.detach()
    tampered_s = time.perf_counter() - t_start
    bad_lineage = recorder.records()
    recorder.clear()
    blamed = [r for r in bad_lineage if r.outcome == "rolled-back"]
    false_at = [i for i, v in enumerate(bad_verdicts[0]) if not v] if bad_verdicts else None
    proposer_set = WINDOW_TAMPERED_BLOCK * window["per_block"]
    print(f"pipeline tampered: block {WINDOW_TAMPERED_BLOCK} (slot {int(bad.message.slot)}) "
          f"raised {caught!r}, Executor.apply_block raises {expected!r}; committed root "
          f"{committed_root.hex()} (block {WINDOW_TAMPERED_BLOCK - 1}'s state root "
          f"{bytes(blocks[WINDOW_TAMPERED_BLOCK - 1].message.state_root).hex()}); a further "
          f"submit refused {refused}; window verdicts false at {false_at} (the proposer set "
          f"{proposer_set}); lineage {[(r.slot, r.disposition, r.verify_route) for r in bad_lineage]}"
          f"; {tampered_s:.1f} s, the pre-state and its root {pre_s:.1f} s of it")
    if caught is None or expected is None or (type(caught), str(caught)) != (
            type(expected), str(expected)):
        sys.exit(f"chip_smoke: the tampered stream raised {caught!r}, Executor.apply_block "
                 f"{expected!r}")
    if committed_root != bytes(blocks[WINDOW_TAMPERED_BLOCK - 1].message.state_root):
        sys.exit("chip_smoke: the tampered stream's committed state is not the block before's")
    if not refused:
        sys.exit("chip_smoke: the broken pipeline took a further block")
    if (len(bad_verdicts) != 1 or false_at != [proposer_set] or len(blamed) != 1
            or blamed[0].slot != int(bad.message.slot) or blamed[0].verify_route != "device"
            or blamed[0].flush_sets != stream_sets
            or blamed[0].blame["error"] != type(caught).__name__):
        sys.exit(f"chip_smoke: the tampered window's route or blame is off: {false_at}, "
                 f"{[r.to_dict() for r in blamed]}")
    faults_moved = {k: c.value() - faults_before[k] for k, c in faults.items()
                    if c.value() != faults_before[k]}
    if faults_moved:
        sys.exit(f"chip_smoke: the pipeline counted faults: {faults_moved}")
    return {"read_s": read_s, "stream_s": stream_s, "wall_s": snap["wall_s"],
            "stage_a_s": snap["stage_a_s"], "stage_b_s": snap["stage_b_s"],
            "settle_s": settle.get("settle_s", 0.0), "verify_s": verify_s,
            "window_loop_plus_device_s": window_device_s, "root": root,
            "launches": launches, "threads": threads, "stats": snap,
            "tampered": {"s": tampered_s, "error": repr(caught), "false_at": false_at,
                         "committed_root": committed_root.hex()},
            # for the serve phase
            "store": store}


# --- the read plane: serving/ and proofs/ over HTTP -------------------------

SERVE_IDS = 16  # the validators and balances requests: 16 indices and 4 pubkeys
SERVE_PUBKEYS = 4
SERVE_DUTIES = 64  # the attester duties request's indices
SERVE_GROUP = 1 << 12  # ssz/core.py's dirty group: 4,096 validator roots
SERVE_PROOF_VALIDATORS = 128  # one in each of 128 groups: 2^19 chunks to rebuild
SERVE_ROUTED = [1 << 18, 1 << 17]  # the columnar rebuild's levels that reach B1
LC_PHASE0_ERROR = "light-client data requires an altair+ state"


def _http(base: str, method: str, path: str, body=None, parts: "dict | None" = None) -> tuple:
    """(status, JSON document, seconds) of one request over HTTP; ``parts``
    gets the client's parse of the body (``parse_s``) and its size."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    request = urllib.request.Request(base + path, data=data, method=method)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(request, timeout=300) as response:
            status, raw = response.status, response.read()
    except urllib.error.HTTPError as err:
        status, raw = err.code, err.read()
    t1 = time.perf_counter()
    doc = json.loads(raw)
    t2 = time.perf_counter()
    if parts is not None:
        parts.update(parse_s=t2 - t1, bytes=len(raw))
    return status, doc, t2 - t0


def _serve_checks(raw, ctx, head, proposer: int, indices: list, duty_ids: list) -> dict:
    """What each request's document must hold, from the head state itself:
    name -> (status, check(document) -> bool). A check runs after its
    request, so the committees it reads are the ones the request cached."""
    from ethereum_consensus_tpu_torch.models.phase0 import helpers as h
    from ethereum_consensus_tpu_torch.serving import oracle

    epoch = int(raw.slot) // ctx.SLOTS_PER_EPOCH
    finality = {name: type(cp).to_json(cp) for name, cp in (
        ("previous_justified", raw.previous_justified_checkpoint),
        ("current_justified", raw.current_justified_checkpoint),
        ("finalized", raw.finalized_checkpoint))}

    def committees_ok(doc):
        rows = doc["data"]
        first = h.get_beacon_committee(raw, epoch * ctx.SLOTS_PER_EPOCH, 0, ctx)
        return (len(rows) == ctx.SLOTS_PER_EPOCH * h.get_committee_count_per_slot(raw, epoch, ctx)
                and sum(len(r["validators"]) for r in rows)
                == len(h.get_active_validator_indices(raw, epoch))
                and rows[0]["validators"] == [str(v) for v in first])

    def duties_ok(doc):
        rows = doc["data"]
        return len(rows) == len(duty_ids) and all(
            h.get_beacon_committee(raw, int(r["slot"]), int(r["committee_index"]), ctx)[
                int(r["validator_committee_index"])] == int(r["validator_index"]) for r in rows)

    return {
        "root": (200, lambda d: d["data"]["root"] == head.root_hex()),
        "finality_checkpoints": (200, lambda d: d["data"] == finality),
        "validators": (200, lambda d: d["data"] == oracle.validators_data(raw, ctx, indices)),
        "validator_balances": (200, lambda d: d["data"] == oracle.balances_data(raw, indices)),
        "committees": (200, committees_ok),
        "proposer_duties": (200, lambda d: len(d["data"]) == ctx.SLOTS_PER_EPOCH and [
            int(r["validator_index"]) for r in d["data"] if int(r["slot"]) == int(raw.slot)]
            == [proposer]),
        "attester_duties": (200, duties_ok),
        "light_client_bootstrap": (400, lambda d: d["message"] == LC_PHASE0_ERROR),
    }


def phase_serve(pipeline: dict, window: dict) -> dict:
    """The read plane on the pipeline phase's tampered stream: the HeadStore
    it fed holds block WINDOW_TAMPERED_BLOCK - 1's committed state and never
    the rolled-back block's. A BeaconDataPlane mounted on an
    IntrospectionServer answers over HTTP on localhost, each request cold
    then warm, under ops.install(device="cuda"): the root, the finality
    checkpoints, validators and balances of SERVE_IDS indices and
    SERVE_PUBKEYS pubkeys, the head epoch's committees, proposer duties,
    attester duties of SERVE_DUTIES indices, a light-client bootstrap (the
    reference's 400 on phase0), and a multiproof of SERVE_PROOF_VALIDATORS
    validator records in as many 4,096-validator groups: on the default
    route (lazy host groups), then on a fresh snapshot of the same state
    under ECT_MESH=1 (the columnar rebuild, its SERVE_ROUTED levels on B1).
    Both give the same bytes, the proof verifies against the head root, and
    B1's launches on the mesh request equal the launch ledger."""
    from ethereum_consensus_tpu_torch import ops
    from ethereum_consensus_tpu_torch.ops import sha256
    from ethereum_consensus_tpu_torch.parallel import runtime
    from ethereum_consensus_tpu_torch.proofs import multiproof, verify_multiproof
    from ethereum_consensus_tpu_torch.serving import BeaconDataPlane
    from ethereum_consensus_tpu_torch.ssz import core
    from ethereum_consensus_tpu_torch.ssz import hash as ssz_hash
    from ethereum_consensus_tpu_torch.telemetry import device
    from ethereum_consensus_tpu_torch.telemetry import server as tel_server
    from ethereum_consensus_tpu_torch.telemetry.server import IntrospectionServer

    store = pipeline["store"]
    blocks = window["signed_blocks"]
    committed = blocks[WINDOW_TAMPERED_BLOCK - 1].message
    rolled_back = bytes(blocks[WINDOW_TAMPERED_BLOCK].message.state_root)
    head = store.head
    published = [(snap.slot, snap.root.hex()) for snap in store.snapshots()]
    print(f"serve: the store holds {published}; head slot {head.slot}, root "
          f"{head.root.hex()}; block {WINDOW_TAMPERED_BLOCK - 1}'s state root "
          f"{bytes(committed.state_root).hex()}, block {WINDOW_TAMPERED_BLOCK}'s (rolled back) "
          f"{rolled_back.hex()}")
    if (head.root != bytes(committed.state_root)
            or head.block_root != type(committed).hash_tree_root(committed)
            or any(root == rolled_back.hex() or slot > int(committed.slot)
                   for slot, root in published)):
        sys.exit("chip_smoke: the head store's head is not the committed block's state, or it "
                 "published the rolled-back block")
    raw, ctx = head.raw, head.context
    n = len(raw.validators)
    epoch = int(raw.slot) // ctx.SLOTS_PER_EPOCH
    ids = [(k * 65_537) % n for k in range(1, SERVE_IDS + 1)]
    keyed = [(k * 40_009 + 7) % n for k in range(1, SERVE_PUBKEYS + 1)]
    pubkeys = ["0x" + bytes(raw.validators[i].public_key).hex() for i in keyed]
    duty_ids = [(k * 16_411) % n for k in range(SERVE_DUTIES)]
    id_list = ",".join([str(i) for i in ids] + pubkeys)
    proof_validators = [2 * k * SERVE_GROUP + (k * 97) % SERVE_GROUP
                        for k in range(SERVE_PROOF_VALIDATORS)]
    gindices = sorted(core.get_generalized_index(type(raw), "validators", i)
                      for i in proof_validators)
    states = "/eth/v1/beacon/states/head"
    requests = [
        ("root", "GET", f"{states}/root", None),
        ("finality_checkpoints", "GET", f"{states}/finality_checkpoints", None),
        ("validators", "GET", f"{states}/validators?id={id_list}", None),
        ("validator_balances", "GET", f"{states}/validator_balances?id={id_list}", None),
        ("committees", "GET", f"{states}/committees?epoch={epoch}", None),
        ("proposer_duties", "GET", f"/eth/v1/validator/duties/proposer/{epoch}", None),
        ("attester_duties", "POST", f"/eth/v1/validator/duties/attester/{epoch}", duty_ids),
        ("light_client_bootstrap", "GET",
         f"/eth/v1/beacon/light_client/bootstrap/0x{head.block_root.hex()}", None),
    ]
    checks = _serve_checks(raw, ctx, head, int(committed.proposer_index), ids + keyed, duty_ids)
    proof_path = f"{states}/proof?gindex={','.join(str(g) for g in gindices)}"

    server = IntrospectionServer(port=0).start(start_flight=False)
    server.mount(BeaconDataPlane(store))
    base = server.url("").rstrip("/")
    walls: dict = {}
    collections: dict = {}  # the collector's full passes during each request
    by_request: dict = {}  # the kernels each request launched
    failed: list = []
    routed: list = []
    build: dict = {}

    def timed_hasher(fn):
        def hasher(nodes: bytes) -> bytes:
            t0 = time.perf_counter()
            out = fn(nodes)
            routed.append((len(nodes) // 64, time.perf_counter() - t0))
            return out
        return hasher

    # the server's side of each request: the data plane's answer, then the
    # JSON encoding and the write (the requests run one at a time)
    served: list = []

    def timed_handle(fn):
        def handle(self, *args):
            t0 = time.perf_counter()
            out = fn(self, *args)
            served.append({"handle_s": time.perf_counter() - t0})
            return out
        return handle

    def timed_send(fn):
        def send_json(self, doc, status=200):
            t0 = time.perf_counter()
            fn(self, doc, status)
            if served:
                served[-1]["encode_send_s"] = time.perf_counter() - t0
        return send_json

    def timed_build(fn):
        def columnar_group_build(pending):
            at = len(routed)
            t0 = time.perf_counter()
            fn(pending)
            build["s"] = time.perf_counter() - t0
            build["routed"] = routed[at:]
        return columnar_group_build

    t_start = time.perf_counter()
    ops.install(device="cuda")
    _zero_launch_counts()
    marks: dict = {}  # request -> (its entry in served, the client's parts)
    stack = contextlib.ExitStack()
    try:
        stack.enter_context(_patched(BeaconDataPlane, "handle", timed_handle))
        stack.enter_context(_patched(tel_server._Handler, "_send_json", timed_send))
        for name, method, path, body in requests:
            status_want, ok = checks[name]
            docs = []
            for turn in ("cold", "warm"):
                full, counts = gc.get_stats()[2]["collections"], _launch_counts()
                parts: dict = {}
                status, doc, wall = _http(base, method, path, body, parts)
                walls[f"{name}_{turn}_s"] = wall
                marks[f"{name}_{turn}"] = (len(served) - 1, parts)
                collections[f"{name}_{turn}"] = gc.get_stats()[2]["collections"] - full
                for kernel, n in _launch_counts().items():
                    if n != counts[kernel]:
                        by_request[f"{name}_{turn}"] = {
                            **by_request.get(f"{name}_{turn}", {}), kernel: n - counts[kernel]}
                docs.append(doc)
                if status != status_want or not ok(doc):
                    failed.append((name, turn, status))
            if docs[0] != docs[1]:
                failed.append((name, "warm != cold", None))
        stack.close()
        host = []
        for turn in ("cold", "warm"):
            status, doc, wall = _http(base, "GET", proof_path)
            walls[f"multiproof_host_{turn}_s"] = wall
            host.append((status, doc))
        # a fresh snapshot of the same committed state: its own walker, so
        # the mesh request plans and rebuilds the same groups again
        store.publish(head.state, ctx, slot=head.slot, root=head.root,
                      block_root=head.block_root, block=head.block)
        runtime.reset()
        os.environ["ECT_MESH"] = "1"
        mesh = []
        try:
            with _patched(ssz_hash, "_device_hasher", timed_hasher), \
                    _patched(multiproof, "_columnar_group_build", timed_build):
                before = _launch_counts()
                device.start()
                status, doc, wall = _http(base, "GET", proof_path)
                torch.cuda.synchronize()
                device.stop()
                after = _launch_counts()
                ledger = device.OBSERVATORY.launches()
            walls["multiproof_mesh_cold_s"] = wall
            mesh.append((status, doc))
            status, doc, wall = _http(base, "GET", proof_path)
            walls["multiproof_mesh_warm_s"] = wall
            mesh.append((status, doc))
            engaged = runtime.status()
        finally:
            os.environ.pop("ECT_MESH", None)
            runtime.reset()
        torch.cuda.synchronize()
        launches = {k: v for k, v in _launch_counts().items() if v}
    finally:
        stack.close()
        ops.uninstall()
        server.stop()
        store.detach()
    serve_s = time.perf_counter() - t_start
    # the stopped server joined its handler threads: every entry is written
    split = {key: {**served[at], **parts} for key, (at, parts) in marks.items()}
    mesh_launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    data = host[0][1]["data"]
    leaves = [bytes.fromhex(x[2:]) for x in data["leaves"]]
    helpers = [bytes.fromhex(x[2:]) for x in data["proof"]]
    verified = verify_multiproof(leaves, helpers, [int(g) for g in data["gindices"]], head.root)
    records = [type(raw.validators[i]).hash_tree_root(raw.validators[i])
               for i in sorted(proof_validators)]
    same = all(d == data for d in (host[1][1]["data"], mesh[0][1]["data"], mesh[1][1]["data"]))

    # B1 alone at the routed levels' shapes, beside the rebuild's wall
    gen = torch.Generator(device="cuda").manual_seed(23)
    kernel_ms = 0.0
    for parents in SERVE_ROUTED:
        words = _random_words(parents, gen)
        kernel_ms += _cuda_ms(lambda: sha256.sha256_64b(words), reps=5)
    in_build = build.get("routed", [])
    routed_s = sum(sec for _n, sec in in_build)
    columnar_s = build.get("s")
    print("serve: requests (cold, warm s; the collector's full passes in each): " + "; ".join(
        f"{name} {walls[name + '_cold_s']:.4f}, {walls[name + '_warm_s']:.4f} "
        f"({collections[name + '_cold']}, {collections[name + '_warm']})"
        for name, *_ in requests))
    print("serve: each request's split (the data plane's answer, the JSON encoding and write, "
          "the client's parse; s, bytes): " + "; ".join(
              f"{key} {round(v.get('handle_s', 0), 4)}, {round(v.get('encode_send_s', 0), 4)}, "
              f"{round(v.get('parse_s', 0), 4)}, {v.get('bytes')}" for key, v in split.items()))
    print(f"serve: multiproof of {len(gindices)} validator records ({len(helpers)} helpers): "
          f"host route {walls['multiproof_host_cold_s']:.4f} s cold, "
          f"{walls['multiproof_host_warm_s']:.4f} warm; ECT_MESH=1 "
          f"{walls['multiproof_mesh_cold_s']:.4f} cold, {walls['multiproof_mesh_warm_s']:.4f} "
          f"warm; the columnar rebuild {columnar_s} s, its routed levels "
          f"{[(p, round(sec, 4)) for p, sec in in_build]} ({routed_s:.4f} s; the request's "
          f"{[p for p, _sec in routed]}), B1 alone at those "
          f"shapes {kernel_ms:.4f} ms; same bytes {same}, verifies {verified}; runtime {engaged}")
    print(f"serve: launches on the path {launches}, by request {by_request}; on the mesh "
          f"request {mesh_launches}, ledger {ledger}; {serve_s:.1f} s")
    if failed:
        sys.exit(f"chip_smoke: the read plane's answers are off: {failed}")
    if not same or not verified or leaves != records or host[0][0] != 200 or mesh[0][0] != 200:
        sys.exit("chip_smoke: the multiproof's routes disagree, or it does not verify against "
                 "the head root")
    if ([p for p, _sec in in_build] != SERVE_ROUTED or columnar_s is None
            or not mesh_launches.get("sha256_64b") or mesh_launches != ledger):
        sys.exit(f"chip_smoke: the mesh request's columnar rebuild did not run on B1 as the "
                 f"ledger says: routed {routed}, launches {mesh_launches}, ledger {ledger}")
    return {"s": serve_s, "walls": walls, "collections": collections, "launches": launches,
            "launches_by_request": by_request, "split": split,
            "mesh_launches": mesh_launches,
            "columnar_s": columnar_s, "routed": in_build, "routed_s": routed_s,
            "b1_kernel_ms": kernel_ms, "helpers": len(helpers), "head": head.root.hex()}


# --- the write plane: pool/ over HTTP, a block produced from the pool -------

# the traffic of bench.py:2756 bench_pool_ingest at the head (slot 4): its
# groups are committees 0..3 of the head's last two slots (the bench takes
# committee 0 of 8 slots; the head has only slots 0..4 behind it), each with
# POOL_AGGREGATORS aggregators of a seeded POOL_PARTICIPATION of its members
POOL_SLOTS = (3, 4)
POOL_COMMITTEES = 4
POOL_AGGREGATORS = 64
POOL_PARTICIPATION = 0.6
POOL_WINDOW = len(POOL_SLOTS) * POOL_COMMITTEES * POOL_AGGREGATORS  # 512: one flush
POOL_BLOCK_SLOT = 5
POOL_SEED = 24
# the spam vocabulary of scenarios/families.py:671 POOL_SPAM_LANES: lane ->
# the reason every admission engine must reject it with
POOL_SPAM_LANES = (
    ("malformed_ssz", "bits_mismatch"),
    ("garbage_signature", "malformed"),
    ("wrong_domain_signature", "signature"),
    ("duplicate", "duplicate"),
    ("subset_bits", "subset"),
    ("future_slot", "future_slot"),
)
POOL_PATH = "/eth/v1/beacon/pool"


def build_pool_spam(attestation, donor_signature: bytes) -> list:
    """One hostile message per spam lane, derived from a valid partial
    ``attestation`` the pool already holds (so ``duplicate`` and
    ``subset_bits`` reach the redundancy verdict, while
    ``wrong_domain_signature`` claims novel bits, so only the pairing can
    reject it), as scenarios/families.py:682 builds them. Returns
    ``[(lane, expected_reason, message), ...]`` in feed order."""
    out = []
    for lane, reason in POOL_SPAM_LANES:
        bad = attestation.copy()
        if lane == "malformed_ssz":
            bad.aggregation_bits = list(bad.aggregation_bits)[:-1]
        elif lane == "garbage_signature":
            bad.signature = b"\x01" * 96  # not a curve point
            bits = list(bad.aggregation_bits)
            if False in bits:  # novel bits, so the parse (not the dedup) rejects it
                bits[bits.index(False)] = True
                bad.aggregation_bits = bits
        elif lane == "wrong_domain_signature":
            bad.signature = bytes(donor_signature)
            bad.aggregation_bits = [True] * len(bad.aggregation_bits)
        elif lane == "subset_bits":
            bits = list(bad.aggregation_bits)
            set_positions = [i for i, b in enumerate(bits) if b]
            if len(set_positions) > 1:
                bits[set_positions[-1]] = False
            bad.aggregation_bits = bits
        elif lane == "future_slot":
            bad.data.slot = int(bad.data.slot) + 10_000
        out.append((lane, reason, bad))
    return out


def _pool_traffic(raw, ctx, blocks: list) -> tuple:
    """(aggregates, their committees): for each group (slot s in POOL_SLOTS,
    committee c < POOL_COMMITTEES) the AttestationData the window's block s
    carries for that committee, and POOL_AGGREGATORS aggregates of a seeded
    POOL_PARTICIPATION of its members, each signed once under
    SecretKey(sum(i + 1)) as build_window signs (those committees' keys are
    real)."""
    from ethereum_consensus_tpu_torch.crypto import bls
    from ethereum_consensus_tpu_torch.crypto.fields import R
    from ethereum_consensus_tpu_torch.domains import DomainType
    from ethereum_consensus_tpu_torch.models.phase0 import build
    from ethereum_consensus_tpu_torch.models.phase0 import helpers as h
    from ethereum_consensus_tpu_torch.signing import compute_signing_root

    ns = build(ctx.preset)
    rng = np.random.default_rng(POOL_SEED)
    domain = h.get_domain(raw, DomainType.BEACON_ATTESTER, 0, ctx)
    aggregates, committees = [], {}
    for slot in POOL_SLOTS:
        carried = blocks[slot].message.body.attestations
        for index in range(POOL_COMMITTEES):
            data = carried[index].data
            if (int(data.slot), int(data.index)) != (slot, index):
                sys.exit(f"chip_smoke: block {slot} does not carry committee {index} of slot "
                         f"{slot} at position {index}")
            committee = h.get_beacon_committee(raw, slot, index, ctx)
            committees[slot, index] = committee
            root = compute_signing_root(ns.AttestationData, data, domain)
            for _ in range(POOL_AGGREGATORS):
                bits = rng.random(len(committee)) < POOL_PARTICIPATION
                members = [committee[i] for i in np.flatnonzero(bits)]
                key = bls.SecretKey(sum(i + 1 for i in members) % R)
                aggregates.append(ns.Attestation(aggregation_bits=bits.tolist(), data=data.copy(),
                                                 signature=key.sign(root).to_bytes()))
    return aggregates, committees


def _nested_timer(parts: dict, key: str, stack: list):
    """A host timer that adds to ``parts[key]`` only on outermost calls
    (``stack`` holds the timed calls in progress), so a root inside
    process_slots is process_slots' time, not the root's."""
    def wrap(fn):
        def timed(*args, **kwargs):
            outer = not stack
            stack.append(key)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                stack.pop()
                if outer:
                    parts[key] = parts.get(key, 0.0) + time.perf_counter() - t0
                    parts[f"{key}_calls"] = parts.get(f"{key}_calls", 0) + 1
        return timed
    return wrap


def _proposer_callbacks():
    """produce_block's randao(state, slot, context) and sign(state, block,
    context) under the proposer's real key SecretKey(i + 1)."""
    from ethereum_consensus_tpu_torch.crypto import bls
    from ethereum_consensus_tpu_torch.domains import DomainType
    from ethereum_consensus_tpu_torch.models.phase0 import helpers as h
    from ethereum_consensus_tpu_torch.signing import compute_signing_root
    from ethereum_consensus_tpu_torch.ssz import uint64

    def randao(state, slot, context):
        epoch = slot // context.SLOTS_PER_EPOCH
        key = bls.SecretKey(h.get_beacon_proposer_index(state, context) + 1)
        domain = h.get_domain(state, DomainType.RANDAO, epoch, context)
        return key.sign(compute_signing_root(uint64, epoch, domain)).to_bytes()

    def sign(state, block, context):
        domain = h.get_domain(state, DomainType.BEACON_PROPOSER, None, context)
        key = bls.SecretKey(int(block.proposer_index) + 1)
        return key.sign(compute_signing_root(type(block), block, domain)).to_bytes()
    return randao, sign


def phase_pool(pipeline: dict, window: dict) -> dict:
    """The write plane on the head store the tampered stream fed (block 2's
    committed state, slot 4, 2^20 validators), under ops.install(device=
    "cuda"): BeaconDataPlane and PoolDataPlane(AdmissionEngine(window_size=
    POOL_WINDOW)) on one IntrospectionServer on localhost, ``submit``
    applying a block through an Executor on a copy of the head and
    publishing it. Timed: the POOL_WINDOW aggregates of _pool_traffic in one
    POST (one flush of 8 fused groups), the scalar twin admitting the same
    containers; produce_block at POOL_BLOCK_SLOT with the proposer's real
    key, its wall split into the state copies, process_slots, selection,
    trials, the replay and its flush, and the root; the block's publication
    over HTTP. Untimed: one message of each spam lane in both engines, the
    views (HTTP against the scalar pool), both selections, the census's
    pool.store owner, the head's root over HTTP, and B6 alone at the
    replay's sets. Every honest message admitted by both engines, each lane
    its reason, the produced block's root the publisher's and the served
    head's, B6 launched on the path and the launch ledger equal to the
    counts, or the run fails."""
    from ethereum_consensus_tpu_torch import ops
    from ethereum_consensus_tpu_torch.crypto import bls
    from ethereum_consensus_tpu_torch.executor import Executor
    from ethereum_consensus_tpu_torch.models.phase0 import block_processing, slot_processing
    from ethereum_consensus_tpu_torch.pool import (AdmissionEngine, OperationPool,
                                                   PoolDataPlane, produce_block,
                                                   select_aggregates)
    from ethereum_consensus_tpu_torch.pool import production
    from ethereum_consensus_tpu_torch.pool import store as pool_store
    from ethereum_consensus_tpu_torch.serving import BeaconDataPlane
    from ethereum_consensus_tpu_torch.telemetry import device, memory, metrics
    from ethereum_consensus_tpu_torch.telemetry.server import IntrospectionServer

    store = pipeline.pop("store")
    head = store.head
    raw, ctx = head.raw, head.context
    blocks = window["signed_blocks"]
    if head.root != bytes(blocks[WINDOW_TAMPERED_BLOCK - 1].message.state_root):
        sys.exit("chip_smoke: the pool phase's head is not the tampered stream's committed state")
    t_start = time.perf_counter()
    with _collector_paused():
        t0 = time.perf_counter()
        aggregates, committees = _pool_traffic(raw, ctx, blocks)
        docs = [type(a).to_json(a) for a in aggregates]
        spam = build_pool_spam(aggregates[0], bytes(blocks[WINDOW_TAMPERED_BLOCK].signature))
        spam_docs = [type(m).to_json(m) for _lane, _reason, m in spam]
        randao, sign = _proposer_callbacks()
        traffic_s = time.perf_counter() - t0
    counters = {k: metrics.counter(f"pool.{k}") for k in (
        "flushes", "fused_groups", "flush_splits", "membership_batch_failures",
        "fallback.fuse_failed", "fallback.no_native")}
    published: dict = {}

    def submit(block):
        t0 = time.perf_counter()
        publisher = Executor(store.head.raw.copy(), ctx)
        t1 = time.perf_counter()
        publisher.apply_block(block)
        t2 = time.perf_counter()
        store.publish(publisher.state, ctx)
        published.update(copy_s=t1 - t0, apply_s=t2 - t1, publish_s=time.perf_counter() - t2,
                         root=type(publisher.state.data).hash_tree_root(publisher.state.data))

    # the shuffle cache keeps the host's committees of epoch 0 from the
    # traffic's build
    ops.install(device="cuda")
    engine = AdmissionEngine(OperationPool(), store, ctx, window_size=POOL_WINDOW)
    twin = AdmissionEngine(OperationPool(), store, ctx, window_size=POOL_WINDOW, rlc=False)
    server = IntrospectionServer(port=0).start(start_flight=False)
    server.mount(BeaconDataPlane(store))
    server.mount(PoolDataPlane(engine, submit=submit))
    base = server.url("").rstrip("/")
    steps: dict = {}  # each step's launches
    parts: dict = {}
    replay_sets: list = []
    try:
        if not engine.rlc:
            sys.exit("chip_smoke: the native backend is missing: no RLC admission engine")
        device.start()
        _zero_launch_counts()

        def step(name: str, fn):
            before = _launch_counts()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            steps[name] = {k: v - before[k] for k, v in _launch_counts().items()
                           if v != before[k]}
            return out, wall

        # -- admission, timed: one request through the RLC window, then the
        # scalar twin on the same containers
        moved = {k: c.value() for k, c in counters.items()}
        (status, doc, _), rlc_s = step("admit_rlc", lambda: _http(
            base, "POST", f"{POOL_PATH}/attestations", docs))
        moved = {k: c.value() - moved[k] for k, c in counters.items()}
        twin_messages = [type(a).from_json(d) for a, d in zip(aggregates, docs)]
        twin_tickets, scalar_s = step("admit_scalar", lambda: [
            twin.admit_attestation(m) for m in twin_messages])
        admitted = {"rlc": (status, doc), "scalar": sorted(
            {(t.status, t.reason) for t in twin_tickets}, key=str)}

        # -- the spam lanes (untimed), both engines
        (spam_status, spam_doc, _), _s = step("spam", lambda: _http(
            base, "POST", f"{POOL_PATH}/attestations", spam_docs))
        spam_rlc = [f["message"] for f in spam_doc.get("failures", [])]
        spam_twin = [twin.admit_attestation(type(m).from_json(d)).reason
                     for (_lane, _reason, m), d in zip(spam, spam_docs)]
        spam_want = [reason for _lane, reason in POOL_SPAM_LANES]

        # -- views, the pool's introspection, the selections (untimed)
        _status, view_doc, _s = _http(base, "GET", f"{POOL_PATH}/attestations")
        twin_view = [type(a).to_json(a) for a in twin.pool.attestations_view()]
        same_views = json.dumps(view_doc["data"], sort_keys=True) == json.dumps(
            twin_view, sort_keys=True)
        _status, pool_doc, _s = _http(base, "GET", "/pool")
        # slots 4 and 5 share epoch 0 and its checkpoints: the head state
        # stands for the production's advanced copy in the eligibility rule
        picks = {}
        for name, pool, scalar in (("rlc", engine.pool, False), ("scalar", twin.pool, True)):
            groups = production.eligible_groups(pool, raw, POOL_BLOCK_SLOT, ctx, "phase0")
            picks[name] = [(g.slot, g.committee_key, g.data_root.hex(), r) for g, r in
                           select_aggregates(groups, int(ctx.MAX_ATTESTATIONS), scalar=scalar)]
        census = memory.census()["pool.store"]
        held = sum(p.memory_census()[1] for p in pool_store.registered_pools())

        # -- production, timed
        stack: list = []
        state_type = type(raw)

        def capture(fn):
            def verify(sets, *args, **kwargs):
                replay_sets.extend(sets)
                return fn(sets, *args, **kwargs)
            return verify

        with contextlib.ExitStack() as patches:
            for owner, name, key in ((slot_processing, "process_slots", "process_slots"),
                                     (production, "select_aggregates", "selection"),
                                     (production, "_trial", "trials"),
                                     (block_processing, "process_block", "replay"),
                                     (bls, "verify_signature_sets", "replay_flush"),
                                     (state_type, "copy", "copies"),
                                     (state_type, "hash_tree_root", "root")):
                patches.enter_context(_patched(owner, name, _nested_timer(parts, key, stack)))
            patches.enter_context(_patched(bls, "verify_signature_sets", capture))
            # one frozen heap for the production and the publication: what
            # the production drops is freed by its reference counts
            gc.collect()
            gc.freeze()
            produced, produce_s = step("produce", lambda: produce_block(
                store.head, engine.pool, ctx, slot=POOL_BLOCK_SLOT, randao=randao, sign=sign))

        # -- publication, timed
        block_doc = type(produced).to_json(produced)
        try:
            (pub_status, pub_doc, _), publish_s = step("publish", lambda: _http(
                base, "POST", "/eth/v2/beacon/blocks", block_doc))
        finally:
            gc.unfreeze()
        _status, root_doc, _s = _http(base, "GET", "/eth/v1/beacon/states/head/root")
        device.stop()
        launches = {k: v for k, v in _launch_counts().items() if v}
        ledger = device.OBSERVATORY.launches()
    finally:
        gc.unfreeze()
        device.stop()
        server.stop()
        ops.uninstall()
    pool_s = time.perf_counter() - t_start

    body = produced.message.body
    keys = sum(len(s.public_keys) for s in replay_sets)
    produce_other = produce_s - sum(v for k, v in parts.items() if not k.endswith("_calls"))
    rate_rlc, rate_scalar = POOL_WINDOW / rlc_s, POOL_WINDOW / scalar_s
    state_root = bytes(produced.message.state_root)
    served_root = root_doc["data"]["root"]
    print(f"pool: head slot {head.slot}, root {head.root.hex()}; traffic {len(aggregates)} "
          f"aggregates in {len(committees)} groups (committees {sorted(committees)}, "
          f"{len(committees[POOL_SLOTS[0], 0])} members each, "
          f"{sum(sum(a.aggregation_bits) for a in aggregates)} signer bits) and "
          f"{len(spam)} spam lanes made in {traffic_s:.1f} s")
    print(f"pool admission: RLC engine over HTTP {rlc_s:.4f} s ({rate_rlc:.1f} admissions/s; "
          f"status {status}, {doc.get('data')}); scalar twin {scalar_s:.4f} s ({rate_scalar:.1f}"
          f"/s); ratio {rate_rlc / rate_scalar:.2f}x; counters moved {moved}; twin tickets "
          f"{admitted['scalar']}")
    print(f"pool spam: RLC {spam_status} {spam_rlc}, scalar {spam_twin} (declared {spam_want})")
    print(f"pool views: {len(view_doc['data'])} served, identical to the scalar pool's "
          f"{same_views}; /pool {json.dumps(pool_doc, sort_keys=True)}; selections "
          f"{len(picks['rlc'])} picks, identical {picks['rlc'] == picks['scalar']}; census "
          f"pool.store {census} (held rows {held})")
    print(f"pool production: slot {int(produced.message.slot)}, proposer "
          f"{int(produced.message.proposer_index)}, {len(body.attestations)} attestations; "
          f"{produce_s:.3f} s wall, parts {_rounded(parts)}, the rest {produce_other:.3f} s; the "
          f"replay's batch {len(replay_sets)} sets, {keys} keys")
    print(f"pool publication: status {pub_status} {pub_doc}; {publish_s:.3f} s wall "
          f"({_rounded({k: v for k, v in published.items() if k.endswith('_s')})}); state root "
          f"{state_root.hex()}, the publisher's {published.get('root', b'').hex()}, served "
          f"{served_root}")
    print(f"pool: launches {launches} by step {steps}; ledger {ledger}")

    failed = []
    if status != 200 or doc.get("data") != {"admitted": str(POOL_WINDOW)}:
        failed.append(f"the RLC engine did not admit every message: {status} {doc}")
    if admitted["scalar"] != [("admitted", None)]:
        failed.append(f"the scalar twin did not admit every message: {admitted['scalar']}")
    if moved["flushes"] != 1 or moved["fused_groups"] != len(committees) or any(
            moved[k] for k in moved if k not in ("flushes", "fused_groups")):
        failed.append(f"not one flush of {len(committees)} fused groups: {moved}")
    if spam_rlc != spam_want or spam_twin != spam_want or spam_status != 400:
        failed.append(f"the spam lanes' reasons are off: {spam_rlc}, {spam_twin}")
    if not same_views or len(view_doc["data"]) != POOL_WINDOW:
        failed.append("the served view is not the scalar pool's")
    if picks["rlc"] != picks["scalar"] or not picks["rlc"]:
        failed.append("the vectorized and scalar selections differ")
    if [(g[0], g[1], g[2]) for g in picks["rlc"]] != [
            (int(a.data.slot), int(a.data.index),
             bytes(type(a.data).hash_tree_root(a.data)).hex()) for a in body.attestations]:
        failed.append("the produced block's attestations are not the selection's picks")
    if census.get("entries") != held or held < 2 * POOL_WINDOW or census.get("bytes", 0) <= 0:
        failed.append(f"the census's pool.store owner does not count the held rows: {census}")
    if (pub_status != 200 or published.get("root") != state_root
            or served_root != "0x" + state_root.hex()):
        failed.append("the produced block's root is not the publisher's or the served head's")
    if (not steps.get("produce", {}).get("g1_sum_sets") or ledger != launches
            or any("g1_sum_sets" in steps.get(k, {}) for k in ("admit_rlc", "admit_scalar"))):
        failed.append(f"B6 did not launch in the production's replay alone among the admissions "
                      f"and production, or the ledger is off: {steps}, {ledger}")
    if failed:
        sys.exit("chip_smoke: " + "; ".join(failed))
    g1_alone = _block_g1_sum("pool", [s for s in replay_sets if len(s.public_keys) > 1])
    return {"s": pool_s, "traffic_s": traffic_s, "rlc_s": rlc_s, "scalar_s": scalar_s,
            "rate_rlc": rate_rlc, "rate_scalar": rate_scalar, "counters": moved,
            "produce_s": produce_s, "produce_parts": parts, "produce_other_s": produce_other,
            "picks": len(picks["rlc"]), "replay_sets": len(replay_sets), "replay_keys": keys,
            "publish_s": publish_s, "published": {k: v for k, v in published.items()
                                                  if k.endswith("_s")},
            "root": state_root.hex(), "launches": launches, "steps": steps, "g1": g1_alone,
            "census": census}


# --- the ECT_MESH route: the sharded twins (B9) ------------------------------

MESH_VIRTUAL_SHARDS = 4
# At 2^20 validators the state walk keeps its large lists as trees of
# 4,096-chunk groups and re-merkleizes only the dirty groups, so no flat
# rebuild reaches the default threshold of 2^15 chunks after the first mesh
# consult: the mesh phase sets the threshold to the group size, and every
# dirty group of the post-epoch roots takes the sharded merkleizer.
MESH_MERKLE_MIN_CHUNKS = 1 << 12
# rows of the captured epoch columns set to u64 edges (zero balances there:
# their products wrap, no add does)
MESH_EDGE_WORDS = (2**63, 2**64 - 1, 2**63 + 12345, 2**40 + 7)
# rewards lane: the fused lane without the inactivity update (8 operations)
REWARDS_OPS = FUSED_OPS - 8
REWARDS_BYTES = 3 * 8 + 1 + 3 + 8
# the flag sums: three masked adds and the masks (9 operations), the
# effective balance, the flags and two masks read
FLAG_SUMS_OPS = 9
FLAG_SUMS_BYTES = 8 + 1 + 2
# MeshEpochSweeps.fused's scalar keywords, in the fused kernel's order
FUSED_KEYWORDS = ("increment", "brpi", "active_increments", "denominator", "bias",
                  "recovery_rate", "weights", "weight_denominator", "leaking",
                  "head_flag_index", "target_flag_index")


@contextlib.contextmanager
def _mesh_env(value: str):
    """ECT_MESH set to ``value`` (and the merkle threshold to the state
    walk's group size) around a fresh runtime."""
    from ethereum_consensus_tpu_torch.parallel import runtime

    runtime.reset()
    os.environ["ECT_MESH"] = value
    os.environ["ECT_MESH_MERKLE_MIN_CHUNKS"] = str(MESH_MERKLE_MIN_CHUNKS)
    try:
        yield runtime
    finally:
        os.environ.pop("ECT_MESH", None)
        os.environ.pop("ECT_MESH_MERKLE_MIN_CHUNKS", None)
        runtime.reset()


def _capture(bucket: list):
    """Record each call's arguments in ``bucket``, then call through."""
    def wrap(fn):
        def recorded(*args, **kwargs):
            bucket.append((args, kwargs))
            return fn(*args, **kwargs)
        return recorded
    return wrap


def _division_count(cols: dict) -> int:
    """The divisions the fused lanes of these columns need (as the
    altair_sweeps phase counts them); the rewards lane needs the same."""
    elig, unslashed = cols["eligible"], cols["active_prev"] & ~cols["slashed"]
    participating = unslashed & (((cols["prev_part"] >> 1) & 1) == 1)
    count = len(elig) + int((elig & ~participating).sum())
    for f in range(3):
        flag_set = unslashed & (((cols["prev_part"] >> f) & 1) == 1)
        count += int((elig & flag_set).sum())
        if f != 2:
            count += int((elig & ~flag_set).sum())
    return count


def _mesh_sweeps(cols: dict, kwargs: dict, meshes: dict) -> dict:
    """MeshEpochSweeps' three entries on ``cols`` at each mesh, bit-exact
    against the unsharded B3 and B5-altair kernels and their plain versions,
    and the wrap census; the three split kernels timed unsharded at 2^20."""
    from ethereum_consensus_tpu_torch.ops import epoch, sweeps
    from ethereum_consensus_tpu_torch.parallel.epoch import MeshEpochSweeps

    names = ("balances", "eff", "prev_part", "slashed", "active_prev", "eligible", "scores")
    host = [cols[k] for k in names]
    dev = [torch.from_numpy(c.view(np.int64) if c.dtype == np.uint64 else c).cuda()
           for c in host]
    fused_kw = {k: kwargs[k] for k in FUSED_KEYWORDS}
    rewards_kw = {k: v for k, v in fused_kw.items() if k not in ("bias", "recovery_rate")}
    scalars = tuple(fused_kw.values())
    rscalars = tuple(rewards_kw.values())
    unsharded_scores, unsharded_balances, wrapped = epoch.fused_epoch_device(
        *host, *scalars, device="cuda")
    plain_scores, plain_balances, _ = epoch.fused_epoch_plain(*dev, *scalars)
    participating = cols["active_prev"] & ~cols["slashed"] & (((cols["prev_part"] >> 1) & 1) == 1)
    part_t, elig_t = (torch.from_numpy(np.ascontiguousarray(c)).cuda()
                      for c in (participating, cols["eligible"]))
    inactivity = sweeps.inactivity_updates(dev[6], part_t, elig_t, kwargs["bias"],
                                           kwargs["recovery_rate"], kwargs["leaking"])
    inactivity_plain = sweeps.inactivity_updates_plain(dev[6], part_t, elig_t, kwargs["bias"],
                                                       kwargs["recovery_rate"], kwargs["leaking"])
    sums = epoch.fused_flag_sums_cuda(*dev[1:5])
    sums_plain = epoch.fused_flag_sums_plain(*dev[1:5])
    post_scores = torch.from_numpy(unsharded_scores.view(np.int64)).cuda()
    rewards_plain, _ = epoch.rewards_apply_plain(*dev[:6], post_scores, sums_plain.tolist(),
                                                 *rscalars)
    want = {
        "fused": (unsharded_scores, unsharded_balances),
        "fused_plain": (plain_scores.cpu().numpy().view(np.uint64),
                        plain_balances.cpu().numpy().view(np.uint64)),
        "inactivity": inactivity.cpu().numpy().view(np.uint64),
        "inactivity_plain": inactivity_plain.cpu().numpy().view(np.uint64),
        "rewards_plain": rewards_plain.cpu().numpy().view(np.uint64),
    }
    ok = (wrapped == 0 and torch.equal(sums, sums_plain)
          and np.array_equal(want["fused"][0], want["fused_plain"][0])
          and np.array_equal(want["fused"][1], want["fused_plain"][1])
          and np.array_equal(want["inactivity"], want["inactivity_plain"])
          and np.array_equal(want["rewards_plain"], unsharded_balances))
    results, launches = {}, {}
    for label, mesh in meshes.items():
        runner = MeshEpochSweeps(mesh)
        _zero_launch_counts()
        t0 = time.perf_counter()
        got_scores, got_balances = runner.fused(*host, **fused_kw)
        fused_s = time.perf_counter() - t0
        got_rewards = runner.rewards(*host[:6], unsharded_scores, **rewards_kw)
        got_inactivity = runner.inactivity_scores(cols["scores"], cols["eligible"],
                                                  participating, kwargs["bias"],
                                                  kwargs["recovery_rate"], kwargs["leaking"])
        launches[label] = _launch_counts()
        hot = cols["balances"].copy()
        hot[1] = np.uint64(2**64 - 1)
        n = len(hot)
        census = runner.fused(hot, cols["eff"], np.full(n, 7, np.uint8), np.zeros(n, bool),
                              np.ones(n, bool), np.ones(n, bool), cols["scores"], **fused_kw)
        exact = (np.array_equal(got_scores, want["fused"][0])
                 and np.array_equal(got_balances, want["fused"][1])
                 and np.array_equal(got_rewards, want["rewards_plain"])
                 and np.array_equal(got_inactivity, want["inactivity"]))
        results[label] = {"exact": exact, "census_none": census is None, "fused_s": fused_s}
        ok &= exact and census is None
    n = len(cols["balances"])
    divisions = _division_count(cols)
    # the launches alone, as the altair_sweeps phase times B3: the census
    # is not read back inside the timed call
    sums_list = sums.tolist()
    census = torch.empty(1, dtype=torch.int64, device="cuda")
    words = epoch._scalars(*scalars)
    rwords = words[:4] + words[6:]
    timings = {
        "fused_flag_sums": (lambda: epoch.fused_flag_sums_cuda(*dev[1:5]),
                            lambda: epoch.fused_flag_sums_plain(*dev[1:5]),
                            _bound(n * FLAG_SUMS_OPS, n * FLAG_SUMS_BYTES + 24)),
        "fused_epoch_apply": (
            lambda: epoch._launch_apply("fused_epoch_apply_launch", "fused_epoch_apply",
                                        tuple(dev), sums_list, words, census, True),
            lambda: epoch.fused_epoch_apply_plain(*dev, sums_list, *scalars),
            _bound(n * FUSED_OPS + divisions * DIV64_OPS, n * FUSED_BYTES)),
        "rewards_apply": (
            lambda: epoch._launch_apply("rewards_apply_launch", "rewards_apply",
                                        (*dev[:6], post_scores), sums_list, rwords, census,
                                        False),
            lambda: epoch.rewards_apply_plain(*dev[:6], post_scores, sums_list, *rscalars),
            _bound(n * REWARDS_OPS + divisions * DIV64_OPS, n * REWARDS_BYTES)),
    }
    out = {}
    for name, (launch, plain, (bound, bound_by)) in timings.items():
        ms = _cuda_ms(launch, reps=50, warmup=5)
        plain_ms = _cuda_ms(plain, reps=5, warmup=1)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                     "max_abs_err": 0 if ok else 1}
        print(f"mesh {name} n={n}: {ms:.4f} ms (bound {bound:.4f} ms by {bound_by}, "
              f"{divisions} divisions); plain {plain_ms:.3f} ms; library: none")
    print(f"mesh sweeps on the altair state's columns (+{len(MESH_EDGE_WORDS)} u64 edge rows): "
          f"{results}; all exact against the unsharded kernels and the plain versions {ok}")
    return {"ok": ok, "meshes": results, "launches": launches, "timings": out}


def _pairing_partials(pk, h, sig, scalars, meshes: dict) -> dict:
    """miller_partials_sharded on the window's sets at each mesh against
    the unsharded route's Miller product and signature sum, limb for limb,
    and its verdict; a blinder-0 lane beside a real one."""
    from ethereum_consensus_tpu_torch.ops import fq, pairing
    from ethereum_consensus_tpu_torch.parallel.pairing import miller_partials_sharded

    xp, yp = pairing.g1_mul_batched(pairing.g1_affine_from_raw(pk, "cuda"), scalars)
    fs = pairing.miller_loop_batched(xp, yp, *pairing.g2_affine_from_raw(h, "cuda"))
    f_want = fq.to_ints(pairing.fp12_product(fs))
    sig_t = torch.stack(pairing.g2_affine_from_raw(sig, "cuda"), dim=1).contiguous()
    s_want = pairing._g2_point_to_raw(pairing.g2_mul_sum(sig_t, pairing.scalar_words(scalars,
                                                                                      "cuda")))
    results, ok = {}, True
    for label, mesh in meshes.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f_total, s_raw, s_inf = miller_partials_sharded(mesh, pk, h, sig, scalars)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        exact = fq.to_ints(f_total) == f_want and (s_raw, s_inf) == s_want
        verdict = pairing.finalize_verdict(f_total, s_raw, s_inf, device=mesh.devices[0])
        results[label] = {"exact": exact, "verdict": verdict, "s": seconds}
        ok &= exact and verdict
    two = sig_t[:2].contiguous()
    with_zero = pairing.g2_mul_sum(two, pairing.scalar_words([scalars[0], 0], "cuda"))
    alone = pairing.g2_mul_sum(two[:1], pairing.scalar_words(scalars[:1], "cuda"))
    zero = pairing.g2_mul_sum(two[:1], pairing.scalar_words([0], "cuda"))
    blinder_zero_ok = (pairing._g2_point_to_raw(with_zero) == pairing._g2_point_to_raw(alone)
                       and not bool(zero.any()))
    print(f"mesh pairing partials on the window's {len(pk)} sets: {results}; a blinder-0 lane "
          f"is the identity {blinder_zero_ok}")
    return {"ok": ok and blinder_zero_ok, "meshes": results}


def _twin_times(cols: dict, kwargs: dict, chunks: bytes, pk, h, sig, scalars) -> dict:
    """Each twin's wall on the card (a synchronize at its end) at the main
    path's shape, at ECT_MESH=1's one shard and at the virtual shards, and
    with its kernels' plain versions in their place, over one call (the
    pairing twin on one set: its plain Miller loop is seconds a lane)."""
    from ethereum_consensus_tpu_torch.ops import epoch, merkle, pairing
    from ethereum_consensus_tpu_torch.parallel import chip_mesh, virtual_mesh
    from ethereum_consensus_tpu_torch.parallel import merkle as pmerkle
    from ethereum_consensus_tpu_torch.parallel.epoch import MeshEpochSweeps
    from ethereum_consensus_tpu_torch.parallel.pairing import miller_partials_sharded

    fused_kw = {k: kwargs[k] for k in FUSED_KEYWORDS}
    host = [cols[k] for k in ("balances", "eff", "prev_part", "slashed", "active_prev",
                              "eligible", "scores")]
    twins = {
        "merkle": lambda m: pmerkle.sharded_merkleize_chunks(chunks, m, limit=2**40),
        "epoch": lambda m: MeshEpochSweeps(m).fused(*host, **fused_kw),
        "pairing": lambda m: miller_partials_sharded(m, pk, h, sig, scalars),
    }
    plain = {
        "merkle": [(merkle, "reduce_levels_cuda", merkle.reduce_levels_plain)],
        "epoch": [(epoch, "fused_flag_sums_cuda", epoch.fused_flag_sums_plain),
                  (epoch, "fused_epoch_apply_cuda", epoch.fused_epoch_apply_plain)],
        "pairing": [(pairing, f"{k}_cuda", getattr(pairing, f"{k}_plain"))
                    for k in ("g1_mul_affine", "miller_loop", "fp12_product", "g2_mul_sum",
                              "g2_sum_points")],
    }
    meshes = {"1": chip_mesh(1), str(MESH_VIRTUAL_SHARDS): virtual_mesh(MESH_VIRTUAL_SHARDS)}

    def wall(fn, mesh) -> float:
        fn(mesh)  # warm
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn(mesh)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return 1e3 * statistics.median(times)

    def once(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    out = {}
    for name, fn in twins.items():
        out[name] = {label: wall(fn, mesh) for label, mesh in meshes.items()}
        with contextlib.ExitStack() as stack:
            for module, attr, replacement in plain[name]:
                stack.enter_context(_patched(module, attr, lambda _fn, r=replacement: r))
            if name == "pairing":
                out[name]["plain_1_set"] = once(lambda: miller_partials_sharded(
                    meshes["1"], pk[:1], h[:1], sig[:1], scalars[:1]))
            else:
                out[name]["plain_1"] = once(lambda: fn(meshes["1"]))
    print(f"mesh twins, ms on the card (plain: the kernels' plain versions in their place): "
          f"{ {k: _rounded(v, 3) for k, v in out.items()} }")
    return out


def _b2_histogram(calls: list) -> dict:
    """The (nodes, depth, start_level) of the B2 calls one cold mesh apply
    made, each shape's count, and its CUDA-event time on the first captured
    input: the apply's B2 time as the sum of count x time."""
    from ethereum_consensus_tpu_torch.ops import merkle

    first, counts = {}, {}
    for (nodes, zero, depth, *rest), kwargs in calls:
        start = rest[0] if rest else kwargs.get("start_level", 0)
        shape = (nodes.shape[1], depth, start)
        counts[shape] = counts.get(shape, 0) + 1
        first.setdefault(shape, (nodes, zero))
    rows = []
    for shape, count in sorted(counts.items(), key=lambda kv: -kv[1]):
        nodes, zero = first[shape]
        ms = _cuda_ms(lambda: merkle.reduce_levels_cuda(nodes, zero, shape[1], shape[2]), reps=10)
        rows.append({"n": shape[0], "depth": shape[1], "start_level": shape[2], "calls": count,
                     "ms": ms})
    total = sum(r["calls"] * r["ms"] for r in rows)
    print(f"mesh altair: B2's {sum(counts.values())} calls by (n, depth, start_level): "
          f"{[(r['n'], r['depth'], r['start_level'], r['calls'], round(r['ms'], 4)) for r in rows]}"
          f"; the apply's B2 time from these timed shapes {total:.4f} ms")
    return {"shapes": rows, "b2_ms": total}


def phase_mesh(altair: dict, window: dict) -> dict:
    """The ECT_MESH route (parallel/): the altair phase's block applied cold
    through Executor.apply_block with ECT_MESH=1 and ops.install(device=
    "cuda") — the sharded fused epoch pass (B3's split launches) and the
    sharded state roots (B2) — with the altair routes' post-state root; the
    window's 528 sets on the sharded RLC route with the host route's
    verdicts and blame; then each twin at the function level, at
    virtual_mesh(4, "cuda") and chip_mesh(1), bit-exact against the
    unsharded kernels on the inputs those runs captured; and ECT_MESH=2 on
    the one card raising."""
    from ethereum_consensus_tpu_torch import ops
    from ethereum_consensus_tpu_torch.models import epoch_vector
    from ethereum_consensus_tpu_torch.models.altair import build
    from ethereum_consensus_tpu_torch.ops import merkle
    from ethereum_consensus_tpu_torch.parallel import chip_mesh, virtual_mesh
    from ethereum_consensus_tpu_torch.parallel import merkle as pmerkle
    from ethereum_consensus_tpu_torch.parallel import pairing as ppairing
    from ethereum_consensus_tpu_torch.parallel import runtime
    from ethereum_consensus_tpu_torch.parallel.epoch import MeshEpochSweeps
    from ethereum_consensus_tpu_torch.ssz.merkle import merkleize_chunks

    ctx, good = altair["ctx"], altair["good"]
    state_type = build(ctx.preset).BeaconState
    engaged, merkle_calls, fused_calls, batches, b2_calls = [], [], [], [], []
    with _mesh_env("1"), contextlib.ExitStack() as stack:
        stack.enter_context(_patched(runtime, "_engage", lambda fn: lambda kind, **inputs: (
            engaged.append(kind), fn(kind, **inputs))[1]))
        stack.enter_context(_patched(pmerkle, "sharded_merkleize_chunks",
                                     _capture(merkle_calls)))
        stack.enter_context(_patched(merkle, "reduce_levels_cuda", _capture(b2_calls)))
        stack.enter_context(_patched(MeshEpochSweeps, "fused", _capture(fused_calls)))
        stack.enter_context(_patched(ppairing, "batch_verify_sharded", _capture(batches)))
        ops.uninstall()
        t0 = time.perf_counter()
        with _collector_paused():  # the apply below freezes what the read made
            state = state_type.deserialize(altair["pre"])
        read_s = time.perf_counter() - t0
        ops.install(device="cuda")
        events: list = []
        timers = [(epoch_vector, "_inactivity_and_rewards", "inactivity_and_rewards"),
                  (MeshEpochSweeps, "fused", "mesh_fused"),
                  (pmerkle, "sharded_merkleize_chunks", "sharded_merkle")]
        fused_mesh = epoch_vector.metrics.counter("epoch_vector.fused.mesh")
        before = fused_mesh.value()
        _zero_launch_counts()
        seconds, parts, post = _apply_altair(state, good, ctx, timers, events)
        launches = _launch_counts()
        apply_b2_calls = list(b2_calls)
        passes = fused_mesh.value() - before
        ops.uninstall()
        digest = hashlib.sha256(state_type.serialize(post)).hexdigest()
        root = state_type.hash_tree_root(post).hex()
        # the registry's 2^20 validator roots, as the root walk keeps them
        # beside the list's tree (chunks, tree, root)
        _, registry_roots, _, registry_root = post.validators._tree_memo
        registry_roots = bytes(registry_roots)
        kernel_ms: dict = {}
        for kname, start, end in events:
            kernel_ms[kname] = kernel_ms.get(kname, 0.0) + start.elapsed_time(end)
        idle = 1.0 - sum(kernel_ms.values()) / (1e3 * seconds)
        apply_kinds = sorted(set(engaged))
        print(f"mesh altair (ECT_MESH=1): read {read_s:.1f} s; apply {seconds:.3f} s "
              f"{_rounded(parts)}; sharded fused passes {passes}; engaged {apply_kinds} "
              f"({len(engaged)} engages, {len(merkle_calls)} sharded roots); launches "
              f"{launches}; kernel ms inside {_rounded(kernel_ms, 4)}; idle share {idle:.6f}")
        print(f"mesh altair: post-state sha256 {digest}, root {root} (the altair routes': "
              f"{altair['root']})")
        del state, post
        gc.collect()
        if (digest, root) != (altair["sha256"], altair["root"]):
            sys.exit("chip_smoke: the altair block's post-state on the ECT_MESH route differs")
        if passes != 1 or not {"epoch", "merkle"} <= set(apply_kinds):
            sys.exit(f"chip_smoke: the ECT_MESH apply did not engage the epoch and merkle "
                     f"twins: {apply_kinds}, {passes} sharded fused passes")
        if min(launches[k] for k in ("merkle_levels", "fused_flag_sums",
                                     "fused_epoch_apply")) == 0 or launches["fused_epoch"]:
            sys.exit(f"chip_smoke: the ECT_MESH apply's launches are off: {launches}")

        engaged.clear()
        route = _verify_route(window["signature_sets"], installed=True)
        blame = _verify_route(window["tampered_sets"], installed=True)
        window_kinds = sorted(set(engaged))
        print(f"mesh window (ECT_MESH=1): {len(route['verdicts'])} sets in {route['s']:.3f} s "
              f"{_rounded(route['parts_s'])}, route {route['route']!r}, all true "
              f"{all(route['verdicts'])}, engaged {window_kinds}; launches {route['launches']}; "
              f"kernel ms inside {_rounded(route['kernel_ms_inside'], 4)}; idle share "
              f"{route['idle_share']:.6f}; tampered copy: false at "
              f"{[i for i, v in enumerate(blame['verdicts']) if not v]} in {blame['s']:.3f} s")
        if (not all(route["verdicts"]) or route["route"] != "device"
                or blame["verdicts"] != window["blame"] or "pairing" not in window_kinds):
            sys.exit("chip_smoke: the window's verdicts or blame on the ECT_MESH route differ")
        if min(route["launches"][k] for k in ("g1_sum_sets", "g1_mul_affine", "g2_mul_sum",
                                               "miller_loop", "fp12_product")) == 0:
            sys.exit(f"chip_smoke: the ECT_MESH window's launches are off: {route['launches']}")

    b2_shapes = _b2_histogram(apply_b2_calls)

    # the function level, on the inputs the main path gave the twins
    meshes = {"1": chip_mesh(1), str(MESH_VIRTUAL_SHARDS): virtual_mesh(MESH_VIRTUAL_SHARDS)}
    host_root = merkleize_chunks(registry_roots, 2**40)
    merkle_ok = host_root == registry_root and all(
        pmerkle.sharded_merkleize_chunks(registry_roots, m, limit=2**40) == host_root
        for m in meshes.values())
    print(f"mesh merkle: the registry's {len(registry_roots) // 32} validator roots at limit "
          f"2^40 on {list(meshes)} shards give the host root and the walk's {merkle_ok}; "
          f"the apply's sharded roots were of {sorted({len(a[0]) // 32 for a, _ in merkle_calls})} "
          f"chunks")
    (_, *fused_args), fused_kwargs = fused_calls[0]
    names = ("balances", "eff", "prev_part", "slashed", "active_prev", "eligible", "scores")
    cols = {k: np.array(v) for k, v in zip(names, fused_args)}
    for i, word in enumerate(MESH_EDGE_WORDS):
        cols["eff"][100 + i] = np.uint64(word)
        cols["scores"][200 + i] = np.uint64(word)
        cols["balances"][100 + i] = cols["balances"][200 + i] = 0
    sweeps_out = _mesh_sweeps(cols, fused_kwargs, meshes)
    pk, h, sig, scalars = max((args[:4] for args, _ in batches), key=lambda a: len(a[0]))
    pairing_out = _pairing_partials(pk, h, sig, scalars, meshes)
    twins = _twin_times({k: np.array(v) for k, v in zip(names, fused_args)}, fused_kwargs,
                        registry_roots, pk, h, sig, scalars)
    if not (merkle_ok and sweeps_out["ok"] and pairing_out["ok"]):
        sys.exit("chip_smoke: a sharded twin disagrees with the unsharded kernels")
    label = str(MESH_VIRTUAL_SHARDS)
    if min(sweeps_out["launches"][label][k] for k in ("fused_flag_sums", "fused_epoch_apply",
                                                       "rewards_apply",
                                                       "inactivity_updates")) == 0:
        sys.exit(f"chip_smoke: the sharded sweeps' launches are off: {sweeps_out['launches']}")

    # no hidden fallback: two devices asked of one card
    with _mesh_env("2") as rt:
        try:
            rt.mesh()
        except RuntimeError as exc:
            refused = str(exc)
        else:
            sys.exit("chip_smoke: ECT_MESH=2 on one card did not raise")
    print(f"mesh: ECT_MESH=2 on {torch.cuda.device_count()} card raises: {refused!r}")
    return {"altair": {"read_s": read_s, "apply_s": seconds, "parts_s": parts,
                       "launches": launches, "kernel_ms_inside": kernel_ms, "idle_share": idle,
                       "engaged": apply_kinds, "root": root},
            "window": {k: route[k] for k in ("s", "route", "launches", "parts_s",
                                             "kernel_ms_inside", "idle_share")}
            | {"blame_s": blame["s"], "engaged": window_kinds},
            "sweeps": {k: sweeps_out[k] for k in ("meshes", "launches")},
            "b2_shapes": b2_shapes, "pairing": pairing_out["meshes"], "twins_ms": twins,
            "timings": sweeps_out["timings"], "refused": refused}


# --- the sharded chain step and the graft entry's twin (B9-step) -------------

STEP_SIZES = (VALIDATORS, VALIDATORS + 5)  # the main path's registry, and an unaligned one
STEP_VIRTUAL_SHARDS = 4
# K1's shard sizes checked beside the main path's 2^20: a 4-shard share, a
# registry of two waves, one SSZ chunk, none
K1_CHECK_NS = (VALIDATORS // 4, (1 << 21) + 4, 4, 0)
# The chain step's shard kernel (K1): the hysteresis update
# (SWEEPS_OPS_PER_VALIDATOR), the masked add of the new effective balance (a
# 64-bit add and a select, 4) and the two byte swaps of its chunk words (one
# PRMT each). Bytes: two words and a flag read, the new effective balance and
# two chunk words written.
CHAIN_STEP_OPS = SWEEPS_OPS_PER_VALIDATOR + 4 + 2
CHAIN_STEP_BYTES = 8 + 8 + 1 + 8 + 8
# The epoch step's sums (K2): the flag sums' masks and adds, and the active
# total's select and add (3). Bytes: the effective balance and four flags.
EPOCH_SUMS_OPS = FLAG_SUMS_OPS + 3
EPOCH_SUMS_BYTES = 8 + 4
# The graft twin's dryrun: its shards, and its block stage's registry (the
# reference's 2^13 validators, minimal preset)
DRYRUN_SHARDS = 4
DRYRUN_BLOCK_VALIDATORS = 1 << 13
STEP_WALL_CALLS = 3


def _chain_columns(n: int, seed: int) -> tuple:
    """Seeded registry columns of the chain step (numpy): effective balances
    in whole increments from 16 to 32 ETH, balances within 1.5 increments of
    them (hysteresis crossings both ways), 5% inactive; u64 edge rows:
    balances within a threshold of 2^64 (the compare wraps) and two active
    rows above 2^63 that their balance keeps (the total wraps mod 2^64)."""
    rng = np.random.default_rng(seed)
    inc = ALTAIR_INCREMENT
    eff = rng.integers(16, 33, n, dtype=np.uint64) * np.uint64(inc)
    balances = (eff.astype(np.int64) + rng.integers(-3 * inc // 2, 3 * inc // 2, n)).astype(
        np.uint64)
    active = rng.random(n) < 0.95
    balances[3] = np.uint64((1 << 64) - 1 - inc // 8)
    balances[5] = np.uint64((1 << 64) - 1)
    eff[3] = np.uint64(32 * inc)
    for i in (7, 11):
        eff[i] = balances[i] = np.uint64(2**63 + 12345 * i)
        active[i] = True
    return balances, eff, active


def _step_epoch_columns(n: int) -> tuple:
    """The epoch step's columns (numpy, the step's order): _altair_columns'
    (words at and above 2^63, scores near 2^64: rows above the score bound),
    validators active in the current epoch, and two u64 edge rows: flag 0's
    sum wraps to 5, below one increment (row 30), and the active total to
    2^64 - 1 (row 31), where the step's isqrt returns 2^32."""
    gen = torch.Generator(device="cuda").manual_seed(20261019)
    c = {k: v.cpu().numpy() for k, v in _altair_columns(n, gen).items()}
    rng = np.random.default_rng(9)
    balances, eff, scores = (c[k].view(np.uint64).copy() for k in ("balances", "eff", "scores"))
    part, slashed, active_prev, eligible = (c[k].copy() for k in (
        "prev_part", "slashed", "active_prev", "eligible"))
    active_cur = active_prev & (rng.random(n) < 0.98)
    part[30], slashed[30], eligible[30] = 1, False, True
    active_prev[30], active_cur[30] = True, False
    part[31], active_prev[31], active_cur[31] = 0, False, True
    eff[30] = eff[31] = 0
    m = (1 << 64) - 1
    flag0 = active_prev & ~slashed & ((part & 1) == 1)
    eff[30] = np.uint64((5 - int(eff[flag0].sum())) & m)
    eff[31] = np.uint64((m - int(eff[active_cur].sum())) & m)
    return balances, eff, part, slashed, active_prev, active_cur, eligible, scores


def _epoch_step_host(cols: tuple, leaking: bool) -> tuple:
    """The epoch step through the host columnar kernels of
    models/epoch_vector.py (numpy u64, wraps included) on the step's scalars:
    (new balances, new scores, total_active)."""
    from ethereum_consensus_tpu_torch.models import epoch_vector as ev
    from ethereum_consensus_tpu_torch.ops import sweeps

    balances, eff, part, slashed, active_prev, active_cur, eligible, scores = cols
    inc = ALTAIR_INCREMENT
    flags = [active_prev & ~slashed & (((part >> f) & 1) == 1) for f in range(3)]
    new_scores = ev.inactivity_scores_kernel(np, scores, eligible, flags[1], ALTAIR_BIAS,
                                             ALTAIR_RECOVERY, leaking)
    total = max(int(eff[active_cur].sum()), inc)
    brpi = inc * ALTAIR_BRF // sweeps.isqrt_u64(total)
    base = (eff // np.uint64(inc)) * np.uint64(brpi)
    pairs = [ev.flag_deltas_kernel(np, base, eligible, flags[f], w, int(eff[flags[f]].sum()) // inc,
                                   total // inc, ALTAIR_WD, leaking, f == 2)
             for f, w in enumerate(ALTAIR_WEIGHTS)]
    missed = eligible & ~flags[1]
    pairs.append((np.zeros_like(eff), np.where(
        missed, eff * new_scores // np.uint64(ALTAIR_BIAS * ALTAIR_QUOTIENT), np.uint64(0))))
    return ev.apply_delta_pairs_kernel(np, balances, pairs), new_scores, total


def _cuda_column(c: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        c.view(np.int64) if c.dtype == np.uint64 else c)).cuda()


def _words_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest |got - want| over unsigned words (64- or 32-bit)."""
    bits = 64 if got.dtype == torch.int64 else 32
    mask = (1 << bits) - 1
    wrong = (got != want).nonzero(as_tuple=True)
    return max((abs((int(a) & mask) - (int(b) & mask)) for a, b in
                zip(got[wrong].tolist(), want[wrong].tolist())), default=0)


def build_dryrun_block() -> tuple:
    """The block stage of the graft twin's dryrun, as the reference's dryrun
    builds it (__graft_entry__.py:291-312): a minimal-preset state of 2^13
    validators, every key real (SecretKey(i + 1)), upgraded to altair at
    epoch 0, and a signed block at slot 4 with one full aggregate per
    committee of slots 0..3 (16 at this size) and a full sync aggregate.
    Returns (pre_state, signed_block, context)."""
    from ethereum_consensus_tpu_torch.config import Context
    from ethereum_consensus_tpu_torch.domains import DomainType
    from ethereum_consensus_tpu_torch.models.altair import build, slot_processing
    from ethereum_consensus_tpu_torch.models.altair import helpers as h
    from ethereum_consensus_tpu_torch.models.altair import upgrade_to_altair

    ctx = Context.for_minimal()
    ctx.altair_fork_epoch = 0
    keys = list(_public_keys(range(DRYRUN_BLOCK_VALIDATORS)).values())
    phase0_state, _ = build_registry_state(DRYRUN_BLOCK_VALIDATORS, ctx, keys.__getitem__)
    state = upgrade_to_altair(phase0_state, ctx)
    target = int(state.slot) + 4
    scratch = state.copy()
    slot_processing.process_slots(scratch, target, ctx)
    ns = build(ctx.preset)
    spe = int(ctx.SLOTS_PER_EPOCH)
    epoch = target // spe
    per_slot = h.get_committee_count_per_slot(scratch, epoch, ctx)
    domain = h.get_domain(scratch, DomainType.BEACON_ATTESTER, epoch, ctx)
    checkpoint = ns.Checkpoint(epoch=epoch, root=h.get_block_root_at_slot(scratch, epoch * spe))
    attestations = [
        _aggregate(ns, ns.AttestationData(
            slot=slot, index=index, beacon_block_root=h.get_block_root_at_slot(scratch, slot),
            source=scratch.current_justified_checkpoint.copy(), target=checkpoint.copy()),
            h.get_beacon_committee(scratch, slot, index, ctx), domain)
        for slot in range(target - 4, target)
        if slot + int(ctx.MIN_ATTESTATION_INCLUSION_DELAY) <= target
        for index in range(per_slot)]
    block, signed = _altair_block(scratch, ctx, target, attestations)
    return state, signed(block), ctx


def _k1_checks(hysteresis: tuple) -> dict:
    """K1 against its plain version at K1_CHECK_NS and on a view one row in
    (every column off the vector path), bit-exact: the largest error of
    each."""
    from ethereum_consensus_tpu_torch.ops import chain_step as cs

    out = {}
    for n in (*K1_CHECK_NS, "offset"):
        rows = VALIDATORS + 4 if n == "offset" else max(n, 12)
        cols = [_cuda_column(c) for c in _chain_columns(rows, seed=rows)]
        cols = [c[1:VALIDATORS + 1] if n == "offset" else c[:n] for c in cols]
        got = cs.chain_step_shard_cuda(*cols, hysteresis)
        want = cs.chain_step_shard_plain(*cols, hysteresis)
        torch.cuda.synchronize()
        out[str(n)] = max(_words_err(a, b) for a, b in zip(got, want))
    return out


def _step_kernels(chain: tuple, cols: tuple, hysteresis: tuple, consts: tuple) -> dict:
    """K1, K2 and K3 against their plain versions on the card at 2^20,
    bit-exact (K1 also at K1_CHECK_NS and one row in), and their CUDA-event
    times beside their bounds (K1 also at 2^18); K1's ptxas lines (a frame
    or a spill fails the run)."""
    from ethereum_consensus_tpu_torch.ops import chain_step as cs

    bal, eff, act = (_cuda_column(c) for c in chain)
    k1 = cs.chain_step_shard_cuda(bal, eff, act, hysteresis)
    p1 = cs.chain_step_shard_plain(bal, eff, act, hysteresis)
    k1_checks = _k1_checks(hysteresis)
    print(f"step chain_step_shard: max_abs_err vs plain by n {k1_checks}")
    dev = [_cuda_column(c) for c in cols]
    sum_cols = tuple(dev[1:6])
    apply_cols = (*dev[:5], dev[6], dev[7])
    k2, p2 = cs.epoch_step_sums_cuda(*sum_cols), cs.epoch_step_sums_plain(*sum_cols)
    sums = p2.tolist()
    k3 = cs.epoch_step_apply_cuda(*apply_cols, sums, *consts)
    p3 = cs.epoch_step_apply_plain(*apply_cols, sums, *consts)
    torch.cuda.synchronize()
    errs = {"chain_step_shard": max(*(_words_err(a, b) for a, b in zip(k1, p1)),
                                    *k1_checks.values()),
            "epoch_step_sums": _words_err(k2, p2),
            "epoch_step_apply": max(_words_err(a, b) for a, b in zip(k3, p3))}
    n = bal.shape[0]
    divisions = _division_count({"eligible": cols[6], "active_prev": cols[4],
                                 "slashed": cols[3], "prev_part": cols[2]})
    args = cs.apply_args(sums, *consts)
    timings = {
        "chain_step_shard": (lambda: cs._launch_chain(bal, eff, act, hysteresis),
                             lambda: cs.chain_step_shard_plain(bal, eff, act, hysteresis),
                             _bound(n * CHAIN_STEP_OPS, n * CHAIN_STEP_BYTES)),
        "epoch_step_sums": (lambda: cs._launch_sums(sum_cols),
                            lambda: cs.epoch_step_sums_plain(*sum_cols),
                            _bound(n * EPOCH_SUMS_OPS, n * EPOCH_SUMS_BYTES + 32)),
        "epoch_step_apply": (lambda: cs._launch_apply(apply_cols, args),
                             lambda: cs.epoch_step_apply_plain(*apply_cols, sums, *consts),
                             _bound(n * FUSED_OPS + divisions * DIV64_OPS, n * FUSED_BYTES)),
    }
    out = {}
    for name, (launch, plain, (bound, bound_by)) in timings.items():
        ms = _cuda_ms(launch, reps=50, warmup=5)
        plain_ms = _cuda_ms(plain, reps=5, warmup=1)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                     "max_abs_err": errs[name]}
        print(f"step {name} n={n}: {ms:.4f} ms (bound {bound:.4f} ms by {bound_by}); plain "
              f"{plain_ms:.3f} ms; library: none; max_abs_err vs plain {errs[name]}")
    quarter = [_cuda_column(c) for c in _chain_columns(VALIDATORS // 4, seed=VALIDATORS // 4)]
    out["chain_step_shard"]["ms_quarter"] = _cuda_ms(
        lambda: cs._launch_chain(*quarter, hysteresis), reps=50, warmup=5)
    ptxas = _ptxas_lines("chain_step", "chain_step_shard_kernel")
    out["chain_step_shard"]["ptxas"] = ptxas
    print(f"step chain_step_shard n={VALIDATORS // 4}: "
          f"{out['chain_step_shard']['ms_quarter']:.4f} ms; ptxas {ptxas}; SASS instructions "
          f"chain_step {_sass_instructions('chain_step')}, K1 "
          f"{_sass_kernel_instructions('chain_step', ('chain_step_shard_kernel',))}")
    if not ptxas or any(line.get("spill_stores") or line.get("stack_frame") for line in ptxas):
        sys.exit("chip_smoke: ptxas gives K1 a frame or spills")
    return out


def _wall_ms(fn) -> float:
    """Host median of STEP_WALL_CALLS calls, each ended by a synchronize,
    after one warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(STEP_WALL_CALLS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def phase_step() -> dict:
    """The sharded chain step and epoch sweep step (parallel/step.py) at
    2^20 validators on chip_mesh(1) and virtual_mesh(4, "cuda"): roots
    against the host SSZ root, totals against numpy, effective balances
    against B5-hysteresis, the epoch step against the host columnar kernels
    and the plain step, the score bound's OverflowError; K1, K2 and K3
    against their plain versions; each step's wall; then the graft twin's
    entry() and dryrun_multichip(4) with its block stage built here."""
    from ethereum_consensus_tpu_torch import graft_entry
    from ethereum_consensus_tpu_torch.config import Context
    from ethereum_consensus_tpu_torch.convert import chunks_from_words
    from ethereum_consensus_tpu_torch.ops import chain_step as cs
    from ethereum_consensus_tpu_torch.ops import sweeps
    from ethereum_consensus_tpu_torch.ops.merkle import zero_hash_words
    from ethereum_consensus_tpu_torch.parallel import chip_mesh, make_chain_step, virtual_mesh
    from ethereum_consensus_tpu_torch.parallel.step import make_epoch_sweep_step, run_chain_step
    from ethereum_consensus_tpu_torch.ssz import List, uint64
    from ethereum_consensus_tpu_torch.ssz.merkle import merkleize_chunks

    phase_t0 = time.perf_counter()
    ctx = Context.for_mainnet()
    hysteresis = sweeps.hysteresis_scalars(ctx)
    consts = (ALTAIR_INCREMENT, ALTAIR_BRF, ALTAIR_BIAS, ALTAIR_RECOVERY, ALTAIR_QUOTIENT,
              ALTAIR_WEIGHTS, ALTAIR_WD, False, 2, 1)
    meshes = {"1": chip_mesh(1), str(STEP_VIRTUAL_SHARDS): virtual_mesh(STEP_VIRTUAL_SHARDS)}
    t0 = time.perf_counter()
    chain = {n: _chain_columns(n, seed=n) for n in STEP_SIZES}
    cols = _step_epoch_columns(VALIDATORS)
    inputs_s = time.perf_counter() - t0

    def chain_step(mesh, n):
        return run_chain_step(make_chain_step(mesh), mesh, *chain[n],
                              zero_hash_words(mesh.devices[0]))

    def epoch_step(mesh, leaking=False):
        return make_epoch_sweep_step(mesh, ctx, is_leaking=leaking, check_score_bound=False)(*cols)

    # the main path: one chain step and one epoch step at 2^20 on the card
    _zero_launch_counts()
    t0 = time.perf_counter()
    main_chain = chain_step(meshes["1"], VALIDATORS)
    main_epoch = epoch_step(meshes["1"])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = _launch_counts()
    print(f"step main path (chain step and epoch step at n={VALIDATORS}, one shard): "
          f"{main_s:.3f} s; launches { {k: v for k, v in launches.items() if v} }")

    checks, ok = {}, True
    for n, (bal, eff, act) in chain.items():
        want_root = List[uint64, 2**40].hash_tree_root([int(b) for b in bal])
        want_eff = sweeps.effective_balance_updates(
            _cuda_column(bal), _cuda_column(eff), ctx).cpu().numpy().view(np.uint64)
        want_total = int(want_eff[act].sum())  # numpy's u64 sum wraps mod 2^64
        for label, mesh in meshes.items():
            new_eff, total, root = (main_chain if (n, label) == (VALIDATORS, "1")
                                    else chain_step(mesh, n))
            exact = (root.astype(">u4").tobytes() == want_root and total == want_total
                     and np.array_equal(new_eff, want_eff))
            checks[f"chain {n} @{label}"] = exact
            ok &= exact
        edges_ok = want_eff[3] == 32 * ALTAIR_INCREMENT and want_total < sum(
            int(e) for e in want_eff[act])
        checks[f"chain {n} edge rows"] = bool(edges_ok)
        ok &= bool(edges_ok)
    dev = [_cuda_column(c) for c in cols]
    sums = cs.epoch_step_sums_plain(*dev[1:6]).tolist()
    for leaking in (False, True):
        want_bal, want_scores, want_total = _epoch_step_host(cols, leaking)
        plain_bal, plain_scores = cs.epoch_step_apply_plain(
            *dev[:5], dev[6], dev[7], sums, *consts[:7], leaking, 2, 1)
        plain_ok = (np.array_equal(plain_bal.cpu().numpy().view(np.uint64), want_bal)
                    and np.array_equal(plain_scores.cpu().numpy().view(np.uint64), want_scores))
        checks[f"epoch plain step leaking={leaking}"] = plain_ok
        ok &= plain_ok
        for label, mesh in meshes.items():
            new_bal, new_scores, total = (main_epoch if (leaking, label) == (False, "1")
                                          else epoch_step(mesh, leaking))
            exact = (np.array_equal(new_bal.cpu().numpy().view(np.uint64), want_bal)
                     and np.array_equal(new_scores.cpu().numpy().view(np.uint64), want_scores)
                     and total == want_total)
            checks[f"epoch leaking={leaking} @{label}"] = exact
            ok &= exact
    edge_ok = sums[0] == 5 and want_total == (1 << 64) - 1
    checks["epoch edge rows (flag sum 5, active total 2^64 - 1)"] = edge_ok
    try:
        make_epoch_sweep_step(meshes["1"], ctx)(*cols)
    except OverflowError:
        checks["epoch score bound raises"] = True
    else:
        checks["epoch score bound raises"] = False
        ok = False
    ok &= edge_ok
    print(f"step checks: {checks}")
    if not ok:
        sys.exit("chip_smoke: the sharded chain step or epoch step disagrees with the host")
    for name in ("chain_step_shard", "epoch_step_sums", "epoch_step_apply", "merkle_levels",
                 "sha256_64b"):
        if launches[name] == 0:
            sys.exit(f"chip_smoke: the step's main path did not launch {name}: {launches}")

    kernels = _step_kernels(chain[VALIDATORS], cols, hysteresis, consts)
    if any(k["max_abs_err"] for k in kernels.values()):
        sys.exit(f"chip_smoke: a step kernel disagrees with its plain version: {kernels}")

    walls = {}
    for label, mesh in meshes.items():
        walls[f"chain@{label}"] = _wall_ms(lambda m=mesh: chain_step(m, VALIDATORS))
        walls[f"epoch@{label}"] = _wall_ms(lambda m=mesh: epoch_step(m))
    print(f"step walls at n={VALIDATORS}, ms (host medians of {STEP_WALL_CALLS} calls, numpy "
          f"in and out): {_rounded(walls)}")

    # the graft entry's twin
    fn, args = graft_entry.entry("cuda")
    entry_root = chunks_from_words(fn(*args)[:, None])
    entry_ok = entry_root == merkleize_chunks(chunks_from_words(args[0]))
    print(f"graft entry(): root {entry_root.hex()} on {args[0].shape[1]} leaves equals the host "
          f"merkleizer's {entry_ok}")
    if not entry_ok:
        sys.exit("chip_smoke: the graft twin's entry() root differs from the host merkleizer")
    t0 = time.perf_counter()
    block = build_dryrun_block()
    block_build_s = time.perf_counter() - t0
    print(f"dryrun block stage: {DRYRUN_BLOCK_VALIDATORS} validators (minimal, every key real), "
          f"block at slot {int(block[1].message.slot)} with "
          f"{len(block[1].message.body.attestations)} aggregates, built in {block_build_s:.1f} s")
    _zero_launch_counts()
    summary = graft_entry.dryrun_multichip(DRYRUN_SHARDS, "cuda", block=block)
    dryrun_launches = _launch_counts()
    print(f"dryrun launches { {k: v for k, v in dryrun_launches.items() if v} }")
    for name in ("chain_step_shard", "epoch_step_sums", "epoch_step_apply", "merkle_levels",
                 "sha256_64b", "g1_sum_sets", "g1_mul_affine", "g2_mul_sum", "miller_loop",
                 "fp12_product"):
        if dryrun_launches[name] == 0:
            sys.exit(f"chip_smoke: the dryrun did not launch {name}: {dryrun_launches}")
    phase_s = time.perf_counter() - phase_t0
    print(f"step phase: {phase_s:.1f} s")
    return {"phase_s": phase_s, "checks": checks, "inputs_s": inputs_s, "main_s": main_s, "launches": launches,
            "kernels": kernels, "walls_ms": walls, "entry_root": entry_root.hex(),
            "block_build_s": block_build_s, "dryrun": summary,
            "dryrun_launches": dryrun_launches}


def _rounded(d: dict, places: int = 3) -> dict:
    return {k: round(v, places) for k, v in d.items()}


# full collections (generation 2, automatic and explicit): their count and
# seconds, read by _walled
_FULL_COLLECTIONS = {"n": 0, "s": 0.0, "t0": None}


def _count_full_collections(phase: str, info: dict) -> None:
    if info.get("generation") != 2:
        return
    if phase == "start":
        _FULL_COLLECTIONS["t0"] = time.perf_counter()
    elif _FULL_COLLECTIONS["t0"] is not None:
        _FULL_COLLECTIONS["n"] += 1
        _FULL_COLLECTIONS["s"] += time.perf_counter() - _FULL_COLLECTIONS["t0"]
        _FULL_COLLECTIONS["t0"] = None


def _walled(name: str, phase, *args):
    """phase(*args), its wall printed with the full collections inside it:
    where the run's 1,200 s go."""
    t0 = time.perf_counter()
    n0, s0 = _FULL_COLLECTIONS["n"], _FULL_COLLECTIONS["s"]
    out = phase(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s wall (full collections "
          f"{_FULL_COLLECTIONS['n'] - n0}, {_FULL_COLLECTIONS['s'] - s0:.1f} s)")
    return out


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)
    started = time.perf_counter()
    gc.callbacks.append(_count_full_collections)
    report = {"device": phase_device()}
    report["build"] = _walled("build", phase_build)
    report["sha256"] = _walled("sha256", phase_sha256)
    report["mxu"] = _walled("mxu", phase_mxu)
    registry = _walled("registry", phase_registry, VALIDATORS)
    report["shuffle"] = _walled("shuffle", phase_shuffle, registry["attester_seed"])
    report["g1"] = _walled("g1", phase_g1, registry["committees"], registry["proposer"])
    report["pairing"] = _walled("pairing", phase_pairing)
    report["htr"] = _walled("htr", phase_htr, HTR_LOG2_LEAVES)
    report["slice"] = _walled("slice", phase_slice, registry["data"], registry["ctx"], SLOTS)
    report["block"] = _walled("block", phase_block, registry)
    report["telemetry"] = _walled("telemetry", phase_telemetry, registry,
                                  report["block"]["signed_block"])
    report["sweeps"] = _walled("sweeps", phase_sweeps)
    report["epoch"] = _walled("epoch", phase_epoch, registry)
    report["altair_sweeps"] = _walled("altair_sweeps", phase_altair_sweeps)
    report["sums"] = _walled("sums", phase_sums)
    report["altair"] = _walled("altair", phase_altair, registry)
    report["window"] = _walled("window", phase_window, registry)
    report["pipeline"] = _walled("pipeline", phase_pipeline, report["window"], registry)
    report["serve"] = _walled("serve", phase_serve, report["pipeline"], report["window"])
    report["pool"] = _walled("pool", phase_pool, report["pipeline"], report["window"])
    report["mesh"] = _walled("mesh", phase_mesh, report["altair"], report["window"])
    report["step"] = _walled("step", phase_step)

    # each kernel's launches on the path it was ported for, and every
    # path's count beside them
    altair_routes = report["altair"]["routes"]
    paths = {"block": report["block"]["launches"], "epoch": report["epoch"]["launches"],
             "altair": altair_routes["device"]["launches"],
             "altair_literal": altair_routes["literal"]["launches"],
             "capella": report["altair"]["capella"]["routes"]["device"]["launches"],
             "deneb": report["altair"]["deneb"]["routes"]["device"]["launches"],
             "electra": report["altair"]["electra"]["routes"]["device"]["launches"],
             "window": report["window"]["routes"]["device"]["launches"],
             "pipeline": report["pipeline"]["launches"],
             "serve": report["serve"]["launches"],
             "pool": report["pool"]["launches"],
             "mxu": report["mxu"]["launches"],
             "window_mxu": report["window"]["routes"]["device_mxu"]["launches"],
             "htr": report["htr"]["launch_counts"],
             "mesh_altair": report["mesh"]["altair"]["launches"],
             "mesh_window": report["mesh"]["window"]["launches"],
             "mesh_sweeps": report["mesh"]["sweeps"]["launches"][str(MESH_VIRTUAL_SHARDS)],
             "step": report["step"]["launches"], "dryrun": report["step"]["dryrun_launches"],
             "telemetry": report["telemetry"]["launches"]}
    electra_g1, block_g1 = report["altair"]["electra"]["g1"], report["g1"]["checks"]["block"]
    print(f"g1_sum_sets at the electra block's {electra_g1['sets']} sets ({electra_g1['keys']} "
          f"keys): {electra_g1['ms']:.4f} ms, {100 * electra_g1['bound_ms'] / electra_g1['ms']:.2f}% "
          f"of its bound {electra_g1['bound_ms']:.4f} ms; at the phase0 block's "
          f"{block_g1['sets']} sets ({block_g1['keys']} keys): {block_g1['ms']:.4f} ms, "
          f"{100 * block_g1['bound_ms'] / block_g1['ms']:.2f}% of {block_g1['bound_ms']:.4f} ms")
    for name, timing in report["altair_sweeps"].items():
        report[name] = timing
    for name in ("g1_mul_affine", "g2_mul_sum", "miller_loop", "fp12_product"):
        report[name] = report["pairing"][name]
        report[f"{name}_mxu"] = report["pairing"]["mxu"][name]
    report["mont_mxu"] = report["mxu"]
    report["g1_sum_sets_mxu"] = report["g1"]["mxu"]
    report["merkle_levels"] = report["htr"]
    for name, timing in report["mesh"]["timings"].items():
        report[name] = timing
    for name, timing in report["step"]["kernels"].items():
        report[name] = timing
    for name, timing in report["telemetry"]["timings"].items():
        report[name] = timing
    sources = {
        "sha256_64b": ("sha256", "block", "ethereum_consensus_tpu_torch/csrc/sha256.cu",
                       "ethereum_consensus_tpu/ops/sha256.py:197"),
        "shuffle": ("shuffle", "block", "ethereum_consensus_tpu_torch/csrc/shuffle.cu",
                    "ethereum_consensus_tpu/ops/shuffle.py:57"),
        "g1_sum_sets": ("g1", "block", "ethereum_consensus_tpu_torch/csrc/g1_sum.cu",
                        "ethereum_consensus_tpu/ops/pairing.py:594"),
        "effective_balance": ("sweeps", "epoch", "ethereum_consensus_tpu_torch/csrc/sweeps.cu",
                              "ethereum_consensus_tpu/ops/sweeps.py:246"),
        "fused_epoch": ("fused_epoch", "altair", "ethereum_consensus_tpu_torch/csrc/fused_epoch.cu",
                        "ethereum_consensus_tpu/models/epoch_vector.py:297"),
        "flag_deltas": ("flag_deltas", "altair_literal",
                        "ethereum_consensus_tpu_torch/csrc/altair_sweeps.cu",
                        "ethereum_consensus_tpu/ops/sweeps.py:67"),
        "inactivity_updates": ("inactivity_updates", "altair_literal",
                               "ethereum_consensus_tpu_torch/csrc/altair_sweeps.cu",
                               "ethereum_consensus_tpu/ops/sweeps.py:147"),
        "inactivity_penalties": ("inactivity_penalties", "altair_literal",
                                 "ethereum_consensus_tpu_torch/csrc/altair_sweeps.cu",
                                 "ethereum_consensus_tpu/ops/sweeps.py:191"),
        "g1_mul_affine": ("g1_mul_affine", "pipeline",
                          "ethereum_consensus_tpu_torch/csrc/pairing.cu",
                          "ethereum_consensus_tpu/ops/pairing.py:316"),
        "g2_mul_sum": ("g2_mul_sum", "pipeline", "ethereum_consensus_tpu_torch/csrc/pairing.cu",
                       "ethereum_consensus_tpu/ops/pairing.py:332"),
        "miller_loop": ("miller_loop", "pipeline", "ethereum_consensus_tpu_torch/csrc/pairing.cu",
                        "ethereum_consensus_tpu/ops/pairing.py:416"),
        "fp12_product": ("fp12_product", "pipeline",
                         "ethereum_consensus_tpu_torch/csrc/pairing.cu",
                         "ethereum_consensus_tpu/ops/pairing.py:474"),
        # the mxu multiplier (EC_PAIRING_MULT=mxu): B8 alone, then B6 and B7
        # on it, each replacing the reference's function under
        # fql.set_multiplier("mxu")
        "mont_mxu": ("mont_mxu", "mxu", "ethereum_consensus_tpu_torch/csrc/mont_mxu.cu",
                     "ethereum_consensus_tpu/ops/fq8.py:300"),
        "g1_sum_sets_mxu": ("g1_sum_sets_mxu", "window_mxu",
                            "ethereum_consensus_tpu_torch/csrc/g1_sum.cu",
                            "ethereum_consensus_tpu/ops/pairing.py:594"),
        "g1_mul_affine_mxu": ("g1_mul_affine_mxu", "window_mxu",
                              "ethereum_consensus_tpu_torch/csrc/pairing.cu",
                              "ethereum_consensus_tpu/ops/pairing.py:316"),
        "g2_mul_sum_mxu": ("g2_mul_sum_mxu", "window_mxu",
                           "ethereum_consensus_tpu_torch/csrc/pairing.cu",
                           "ethereum_consensus_tpu/ops/pairing.py:332"),
        "miller_loop_mxu": ("miller_loop_mxu", "window_mxu",
                            "ethereum_consensus_tpu_torch/csrc/pairing.cu",
                            "ethereum_consensus_tpu/ops/pairing.py:416"),
        "fp12_product_mxu": ("fp12_product_mxu", "window_mxu",
                             "ethereum_consensus_tpu_torch/csrc/pairing.cu",
                             "ethereum_consensus_tpu/ops/pairing.py:474"),
        # the ECT_MESH route: B2 under the sharded state root (and alone on
        # the htr path), B3's launches apart under the sharded epoch pass,
        # the rewards lane under the sharded staged rewards
        "merkle_levels": ("merkle_levels", "mesh_altair",
                          "ethereum_consensus_tpu_torch/csrc/merkle.cu",
                          "ethereum_consensus_tpu/ops/merkle.py:44"),
        "fused_flag_sums": ("fused_flag_sums", "mesh_altair",
                            "ethereum_consensus_tpu_torch/csrc/fused_epoch.cu",
                            "ethereum_consensus_tpu/parallel/epoch.py:88"),
        "fused_epoch_apply": ("fused_epoch_apply", "mesh_altair",
                              "ethereum_consensus_tpu_torch/csrc/fused_epoch.cu",
                              "ethereum_consensus_tpu/parallel/epoch.py:88"),
        "rewards_apply": ("rewards_apply", "mesh_sweeps",
                          "ethereum_consensus_tpu_torch/csrc/fused_epoch.cu",
                          "ethereum_consensus_tpu/parallel/epoch.py:132"),
        # the sharded chain step and epoch sweep step (B9-step): the shard
        # pass of make_chain_step's body, and the sums and element pass of
        # _epoch_sweep_step's
        "chain_step_shard": ("chain_step_shard", "step",
                             "ethereum_consensus_tpu_torch/csrc/chain_step.cu",
                             "ethereum_consensus_tpu/parallel/step.py:112"),
        "epoch_step_sums": ("epoch_step_sums", "step",
                            "ethereum_consensus_tpu_torch/csrc/chain_step.cu",
                            "ethereum_consensus_tpu/parallel/step.py:294"),
        "epoch_step_apply": ("epoch_step_apply", "step",
                             "ethereum_consensus_tpu_torch/csrc/chain_step.cu",
                             "ethereum_consensus_tpu/parallel/step.py:294"),
        # the staged programs of jitted_kernels(), launched through it: the
        # transition takes only the fused kernel
        "staged_inactivity_scores": ("staged_inactivity_scores", "telemetry",
                                     "ethereum_consensus_tpu_torch/csrc/epoch_staged.cu",
                                     "ethereum_consensus_tpu/models/epoch_vector.py:234"),
        "staged_flag_deltas": ("staged_flag_deltas", "telemetry",
                               "ethereum_consensus_tpu_torch/csrc/epoch_staged.cu",
                               "ethereum_consensus_tpu/models/epoch_vector.py:251"),
        "staged_apply_delta_pairs": ("staged_apply_delta_pairs", "telemetry",
                                     "ethereum_consensus_tpu_torch/csrc/epoch_staged.cu",
                                     "ethereum_consensus_tpu/models/epoch_vector.py:285"),
    }
    kernels = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": paths[path][name],
        "launches_by_path": {p: counts.get(name, 0) for p, counts in paths.items()},
        "matched_plain": report[phase]["max_abs_err"] == 0,
        "max_abs_err": report[phase]["max_abs_err"],
        "ms": report[phase]["ms"],
        "plain_ms": report[phase]["plain_ms"],
        "bound_ms": report[phase]["bound_ms"],
        "bound_by": report[phase]["bound_by"],
        "library_ms": None,
    } for name, (phase, path, source, replaces) in sources.items()]}
    print(f"run: {time.perf_counter() - started:.1f} s (full collections "
          f"{_FULL_COLLECTIONS['n']}, {_FULL_COLLECTIONS['s']:.1f} s)")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": report["device"]["kind"],
        "count": report["device"]["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
