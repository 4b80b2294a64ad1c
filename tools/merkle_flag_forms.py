"""B2 (the multi-level merkle root, csrc/merkle.cu) and the flag deltas
(csrc/altair_sweeps.cu) beside their measured alternatives and their
earlier designs, on one card and the same seeded inputs: every form checked
against the plain version, then timed with chip_smoke's CUDA-event timer in
turns (kernel, alternative, alternative, kernel).

    python3 tools/merkle_flag_forms.py [--parent DIR] [--json PATH]   # repo root, CUDA machine

B2's forms, at 2^20 leaves and at 2^15, limit 2^40 (tools/merkle_forms.cu):
the program's kernel (the block launch, then the tail's launch of one
block), each of its two launches alone, other block sizes, and the
register-subtree form (a thread's 4 or 8 leaves reduced in registers from
16-byte loads, at 4 and at 2 blocks an SM; each alone, and checked also at
n - 3 leaves, its 4-byte path). The flag deltas' forms at 2^20
(tools/flag_forms.cu): the program's cooperative launch, two launches (the
sums with the penalties, then the rewards), each alone, and the kernel and
earlier design with the L2 flushed by a read. With ``--parent DIR``, a tree
of the commit before these designs (``git archive`` of it unpacked there),
its B2 and flag deltas are built from DIR and timed beside them, and its B2
also at four blocks an SM (tools/merkle_parent_64.cu, at most 64 registers).
Also one thread's latency of 40 dependent messages (``clock64``), the tree's
depth at limit 2^40. Each build's ptxas lines are printed; ``--json`` also
writes every result to PATH. The alternatives are measurements, not part
of the program.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from ethereum_consensus_tpu_torch import _kernels, convert  # noqa: E402
from ethereum_consensus_tpu_torch.ops import merkle, sweeps  # noqa: E402

TOOLS = os.path.join(ROOT, "tools")
CSRC = os.path.join(ROOT, "ethereum_consensus_tpu_torch", "csrc")
MERKLE_SHAPES = ((1 << 20, 40), (1 << 15, 40))
BLOCK_LOG2_TRIED = (8, 9, 10, 11)  # block sizes tried beside the kernel's
FLAG_N = 1 << 20
PROGRAM_LIBRARIES = ("merkle", "altair_sweeps")
SUBTREE_FORMS = ((2, 4), (3, 4), (2, 2), (3, 2))  # (log2 of a thread's leaves, blocks an SM)
_P, _I, _I64, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint64
MERKLE_ARGS = [_P, _I64, _P, _I, _I, _P, _P, _P]
FLAG_ARGS = [_P, _P, _P, _I64] + [_U64] * 5 + [_I, _I, _P]


def _build(name: str, source: str, include: str, flags: tuple = ()) -> tuple:
    """nvcc of ``source`` with ``include`` on the include path and the extra
    ``flags``; returns (library, log)."""
    work = os.path.join(_kernels._BUILD, "forms")
    os.makedirs(work, exist_ok=True)
    lib = os.path.join(work, f"lib{name}.so")
    r = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, *flags, f"-I{include}", "-o", lib,
                        source], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
    return lib, r.stdout + r.stderr


def _sass_profile(lib_path: str) -> dict:
    """Per kernel of a built library: its SASS instructions, and those of
    the opcodes that set a SHA-256 message's pace (local memory, the
    integer pipe's shifts, logic and adds, the FMA pipe's IMAD)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True).stdout
    out, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = line.split("Function :")[1].strip()
            out[current] = {"instructions": 0}
            continue
        text = line.strip()
        if current is None or not text.startswith("/*") or "*/" not in text:
            continue
        op = text.split("*/", 1)[1].strip().split(" ")[0].rstrip(";")
        if op.startswith("@"):
            op = text.split("*/", 1)[1].strip().split(" ")[1]
        if not op or op.startswith("/*"):
            continue
        counts = out[current]
        counts["instructions"] += 1
        base = op.split(".")[0]
        if base in ("LDL", "STL", "SHF", "LOP3", "IADD3", "IMAD", "PRMT", "LDS", "STS", "LDG",
                    "BAR", "BRA"):
            counts[base] = counts.get(base, 0) + 1
    return out


def _ptxas(log: str) -> list:
    return [line.strip() for line in log.splitlines()
            if any(w in line for w in ("registers", "spill", "stack frame", "entry function"))]


def _bind(lib_path: str, functions: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(lib_path)
    for fn, argtypes in functions.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _builds(parent: str | None) -> dict:
    forms = os.path.join(TOOLS, "merkle_forms.cu")
    jobs = {"merkle_forms": (forms, CSRC),
            "flag_forms": (os.path.join(TOOLS, "flag_forms.cu"), CSRC)}
    for k, blocks in SUBTREE_FORMS:
        jobs[f"subtree_k{k}_{blocks}_blocks"] = (
            forms, CSRC, (f"-DSUBTREE_K={k}", f"-DSUBTREE_MIN_BLOCKS={blocks}"))
    if parent:
        pcsrc = os.path.join(parent, "ethereum_consensus_tpu_torch", "csrc")
        jobs["merkle_parent"] = (os.path.join(pcsrc, "merkle.cu"), pcsrc)
        jobs["merkle_parent_64"] = (os.path.join(TOOLS, "merkle_parent_64.cu"), pcsrc)
        jobs["flags_parent"] = (os.path.join(pcsrc, "altair_sweeps.cu"), pcsrc)
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(jobs) + 1) as pool:
        program = pool.submit(_kernels.build_all)
        futures = {name: pool.submit(_build, name, *job) for name, job in jobs.items()}
        out = {name: f.result() for name, f in futures.items()}
        program.result()
    logs = {name: _kernels.build_log(name) for name in PROGRAM_LIBRARIES}
    logs.update({name: log for name, (_, log) in out.items()})
    for name, log in logs.items():
        for line in _ptxas(log):
            print(f"  ptxas {name}: {line}")
    for name in out:
        if name.startswith(("merkle", "subtree")):
            for kernel, counts in _sass_profile(out[name][0]).items():
                if "merkle" in kernel:
                    print(f"  SASS {name} {kernel[-40:]}: {counts}")
    return out


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _turns(candidates: dict, reps: int, warmup: int = 2, timer=None) -> dict:
    """Each alternative timed in turns with the kernel (kernel, it, it,
    kernel)."""
    timer = timer or chip_smoke._cuda_ms
    times = {name: [] for name in candidates}
    for name in candidates:
        if name == "kernel":
            continue
        for turn in ("kernel", name, name, "kernel"):
            times[turn].append(timer(candidates[turn], reps=reps, warmup=warmup))
    return times


def merkle_forms(libs: dict) -> dict:
    zero = merkle.zero_hash_words("cuda")
    form_args = MERKLE_ARGS + [_I, _I]
    program = _bind(libs["merkle_forms"][0], {"merkle_form_launch": form_args})
    subtrees = {name: _bind(libs[name][0], {"merkle_subtree_launch": MERKLE_ARGS + [_I]})
                for name in libs if name.startswith("subtree")}
    parents = {name: _bind(libs[name][0], {"merkle_root_launch": MERKLE_ARGS})
               for name in ("merkle_parent", "merkle_parent_64") if name in libs}
    rng = np.random.default_rng(12)
    out = {}
    for n, depth in MERKLE_SHAPES:
        words = convert.words_from_chunks(rng.bytes(32 * n), "cuda")
        want = merkle.reduce_levels_plain(words, zero, depth)
        root = torch.empty(8, dtype=torch.int32, device="cuda")

        def form(lib, b, mode, work=torch.empty((8, n // 128 + 64), dtype=torch.int32,
                                                device="cuda")):
            def run():
                rc = lib.merkle_form_launch(words.data_ptr(), n, zero.data_ptr(), 0, depth,
                                            work.data_ptr(), root.data_ptr(), _stream(), b, mode)
                if rc <= 0:
                    raise RuntimeError(f"form launch failed at b={b}, mode {mode}")
            return run

        def parent(lib, work=torch.empty((8, n // 128 + 64), dtype=torch.int32, device="cuda")):
            def run():
                rc = lib.merkle_root_launch(words.data_ptr(), n, zero.data_ptr(), 0, depth,
                                            work.data_ptr(), root.data_ptr(), _stream())
                if rc <= 0:
                    raise RuntimeError("parent launch failed")
            return run

        def subtree(lib, mode, nodes=words, count=n,
                    work=torch.empty((8, n // 128 + 64), dtype=torch.int32, device="cuda")):
            def run():
                rc = lib.merkle_subtree_launch(nodes.data_ptr(), count, zero.data_ptr(), 0, depth,
                                               work.data_ptr(), root.data_ptr(), _stream(), mode)
                if rc <= 0:
                    raise RuntimeError(f"subtree launch failed, mode {mode}")
            return run

        b = merkle._block_log2(n)
        split = torch.empty((8, n // 128 + 64), dtype=torch.int32, device="cuda")
        candidates = {"kernel": lambda: merkle.reduce_levels_cuda(words, zero, depth),
                      f"first_launch_alone_b{b}": form(program, b, 2, split),
                      f"second_launch_alone_b{b}": form(program, b, 3, split)}
        for name, lib in subtrees.items():
            candidates[name] = subtree(lib, 1)
            candidates[f"{name}_first_launch_alone"] = subtree(lib, 2)
        for other in BLOCK_LOG2_TRIED:
            if other != b and merkle.TAIL_NODES << other >= n > 1 << other:
                candidates[f"blocks_b{other}"] = form(program, other, 1)
        for name, lib in parents.items():
            candidates[name] = parent(lib)
        errs = {}
        for name, fn in candidates.items():
            if "first_launch_alone" in name:
                continue
            if name.startswith("second_launch_alone"):
                candidates[f"first_launch_alone_b{b}"]()
            got = fn()
            torch.cuda.synchronize()
            got = root if got is None else got
            errs[name] = chip_smoke._max_err(got, want)
        # the subtree forms' 4-byte path: a count that is not a multiple of 4
        odd = words[:, : n - 3].contiguous()
        want_odd = merkle.reduce_levels_plain(odd, zero, depth)
        for name, lib in subtrees.items():
            subtree(lib, 1, odd, n - 3)()
            torch.cuda.synchronize()
            errs[f"{name}_at_n_minus_3"] = chip_smoke._max_err(root, want_odd)
        times = _turns(candidates, reps=20)
        bound, bound_by = chip_smoke.merkle_bound_ms(n, depth)
        print(f"B2 forms at {n} leaves, depth {depth}: max_abs_err vs plain {errs}; ms {times} "
              f"(bound {bound:.4f} ms by {bound_by})")
        out[f"{n}-{depth}"] = {"errs": errs, "ms": times, "bound_ms": bound}
    return out


def _cuda_ms_clean(fn, reps: int, warmup: int = 2) -> float:
    """chip_smoke._cuda_ms with the L2 flushed by a read of twice its size in
    place of a write: the cache then holds clean lines, and the timed call
    writes none of the flush's dirty lines back."""
    for _ in range(warmup):
        fn()
    flush = torch.zeros(chip_smoke.L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    flush.sum()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(chip_smoke.SPIN_CYCLES)
        flush.sum()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def flag_forms(libs: dict) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(12)
    c = chip_smoke._altair_columns(FLAG_N, gen)
    eff, part, elig = c["eff"], c["participating"], c["eligible"]
    scalars = (chip_smoke.ALTAIR_TOTAL_ACTIVE, chip_smoke.ALTAIR_WEIGHTS[1],
               chip_smoke.ALTAIR_INCREMENT, chip_smoke.ALTAIR_BRF, chip_smoke.ALTAIR_WD, 0, 0)
    want = sweeps.flag_deltas_plain(eff, part, elig, *scalars[:5], False, False)
    two = _bind(libs["flag_forms"][0], {"flag_deltas_two_launch": FLAG_ARGS + [_I64, _P, _P, _P]})
    rewards, penalties = torch.empty_like(eff), torch.empty_like(eff)
    scratch = torch.empty(sweeps.FLAG_DELTAS_SCRATCH_WORDS, dtype=torch.int64, device="cuda")

    def two_launch():
        rc = two.flag_deltas_two_launch(eff.data_ptr(), part.data_ptr(), elig.data_ptr(), FLAG_N,
                                        *scalars, scratch.data_ptr(),
                                        sweeps.FLAG_DELTAS_SCRATCH_WORDS, rewards.data_ptr(),
                                        penalties.data_ptr(), _stream())
        if rc != 0:
            raise RuntimeError(f"two-launch flag deltas failed: {rc}")
        return rewards, penalties

    split = _bind(libs["flag_forms"][0], {
        "flag_sums_launch": FLAG_ARGS + [_I64, _P, _P, _P],
        "flag_apply_launch": FLAG_ARGS + [_I64, _P, _P, _P]})
    words = sweeps.FLAG_DELTAS_SCRATCH_WORDS

    def sums_alone():
        rc = split.flag_sums_launch(eff.data_ptr(), part.data_ptr(), elig.data_ptr(), FLAG_N,
                                    *scalars, scratch.data_ptr(), words, rewards.data_ptr(),
                                    penalties.data_ptr(), _stream())
        if rc != 0:
            raise RuntimeError(f"flag sums failed: {rc}")

    def apply_alone():
        rc = split.flag_apply_launch(eff.data_ptr(), part.data_ptr(), elig.data_ptr(), FLAG_N,
                                     *scalars, scratch.data_ptr(), words, rewards.data_ptr(),
                                     penalties.data_ptr(), _stream())
        if rc != 0:
            raise RuntimeError(f"flag apply failed: {rc}")
        return rewards, penalties

    def kernel():
        return sweeps._launch_flag_deltas(eff, part, elig, scalars)

    candidates = {"kernel": kernel, "two_launches": two_launch, "sums_alone": sums_alone,
                  "apply_alone": apply_alone}
    if "flags_parent" in libs:
        old = _bind(libs["flags_parent"][0], {"flag_deltas_launch": FLAG_ARGS + [_P, _P, _P]})
        word = torch.empty(1, dtype=torch.int64, device="cuda")

        def parent():
            rc = old.flag_deltas_launch(eff.data_ptr(), part.data_ptr(), elig.data_ptr(), FLAG_N,
                                        *scalars, word.data_ptr(), rewards.data_ptr(),
                                        penalties.data_ptr(), _stream())
            if rc != 0:
                raise RuntimeError(f"parent flag deltas failed: {rc}")
            return rewards, penalties
        candidates["parent"] = parent
    errs = {}
    for name, fn in candidates.items():
        if name == "sums_alone":
            continue
        if name == "apply_alone":
            sums_alone()
        got = fn()
        torch.cuda.synchronize()
        errs[name] = max(chip_smoke._max_err(g, w) for g, w in zip(got, want))
    times = _turns(candidates, reps=50, warmup=5)
    tiny = torch.zeros(1, device="cuda")
    floor = chip_smoke._cuda_ms(lambda: tiny.add_(1), reps=50, warmup=5)
    print(f"the timer's floor (one one-element add) {1e3 * floor:.2f} us")
    other = "parent" if "parent" in candidates else "two_launches"
    clean = _turns({"kernel": kernel, other: candidates[other]}, reps=50, warmup=5,
                   timer=_cuda_ms_clean)
    print(f"flag deltas forms at n={FLAG_N}: max_abs_err vs plain {errs}; ms {times}; with the "
          f"L2 flushed by a read: {clean}")
    return {"errs": errs, "ms": times, "ms_read_flush": clean,
            "timer_floor_ms": floor}


def latency(libs: dict) -> dict:
    """One thread's clock64 cycles for 40 dependent messages, in the
    program's build and in the parent's where it has the latency kernel."""
    builds = {"kernel": _kernels.load("merkle")}
    if "merkle_parent" in libs:
        parent = ctypes.CDLL(libs["merkle_parent"][0])
        if hasattr(parent, "merkle_latency_launch"):
            builds["parent"] = _bind(libs["merkle_parent"][0],
                                     {"merkle_latency_launch": [_P, _I, _P, _P, _P]})
    zero = merkle.zero_hash_words("cuda")
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    root = torch.empty(8, dtype=torch.int32, device="cuda")
    out = {"root_ok": True}
    for name, lib in builds.items():
        readings = []
        for _ in range(5):
            rc = lib.merkle_latency_launch(zero.data_ptr(), 40, cycles.data_ptr(),
                                           root.data_ptr(), _stream())
            if rc != 0:
                raise RuntimeError(f"latency launch failed: {rc}")
            torch.cuda.synchronize()
            readings.append(int(cycles.item()))
        ok = torch.equal(root, zero[40])
        out["root_ok"] &= ok
        out[f"cycles_40_{name}"] = readings
        print(f"B2 latency ({name}): 40 dependent messages on one thread, clock64 cycles "
              f"{readings}; root is the zero word of level 40 {ok}; clocks {chip_smoke._clocks()}")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a tree of the commit before these designs")
    parser.add_argument("--json", help="a file to write every result to")
    args = parser.parse_args()
    report = {"device": chip_smoke.phase_device()}
    libs = _builds(args.parent)
    report["latency"] = latency(libs)
    report["merkle"] = merkle_forms(libs)
    report["flag_deltas"] = flag_forms(libs)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    bad = [k for k, v in report["merkle"].items() if any(v["errs"].values())]
    if bad or any(report["flag_deltas"]["errs"].values()) or not report["latency"]["root_ok"]:
        print(f"merkle_flag_forms: a form disagrees with the plain version: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
