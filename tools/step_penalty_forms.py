"""K1 (the chain step's shard kernel, csrc/chain_step.cu) and the inactivity
penalties (csrc/altair_sweeps.cu) beside their measured alternatives and the
earlier designs, on one card and the same seeded columns: every form checked
bit-exact against its plain version, then timed with chip_smoke's CUDA-event
timer in turns (kernel, form, form, kernel), after its write flush and after
a read flush.

    python3 tools/step_penalty_forms.py [--parent DIR] [--json PATH]   # repo root, CUDA machine

At 2^20 validators and at 2^18 (a 4-shard share). K1's forms
(``tools/step_forms.cu``, numbered there): a block's contiguous range of
chunks at two and at one chunk a thread a step (the first design), with
the grid sync and with the program's finish (the total zeroed on the
stream, one atomic a block), staged in shared memory, on plain loads and at
three blocks an SM; the parent's two-wave schedule on the new lane; a
grid-stride partition of chunks; persistent grids that load each thread's
next chunk ahead; the program's warp chunks with the grid sync in one
cooperative launch, and on warp chunks of 128 and 512 validators; and
probes, not checked: kernels without their finish, with and without
arithmetic. The penalties' forms
(``tools/penalty_forms.cu``): the kernel on one, two and four blocks an SM,
with its warps' chunks in the program's order and dealt round the blocks
first, beside the kernel's grid of a chunk a warp. With
``--parent DIR``, a tree of the commit before these designs (``git
archive`` of it unpacked there), its ``chain_step.cu`` and
``altair_sweeps.cu`` are built from DIR and their kernels timed beside the
program's, and so are the flag deltas and B5-hysteresis, whose code this
design leaves as it was (the parents' builds of ``altair_sweeps.cu`` and
``sweeps.cu`` against the program's). A PyTorch copy of as many bytes as
each kernel moves (half read, half written) and an empty launch
(``torch.cuda._sleep(0)``) are the floors under this timer. Each build's
registers, frame and spills and each kernel's SASS instructions and
local-memory accesses are printed and kept; ``--json`` also writes every
result to PATH. The forms and the earlier designs are measurements, not
part of the program.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import re
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from ethereum_consensus_tpu_torch import _kernels  # noqa: E402
from ethereum_consensus_tpu_torch.config import Context  # noqa: E402
from ethereum_consensus_tpu_torch.ops import chain_step, epoch, sweeps  # noqa: E402
from tools.merkle_flag_forms import _bind, _build, _cuda_ms_clean, _stream, _turns  # noqa: E402
from tools.sums_forms import _ptxas_lines, _sass  # noqa: E402

SIZES = (1 << 20, 1 << 18)
CSRC = os.path.join(ROOT, "ethereum_consensus_tpu_torch", "csrc")
_P, _I, _I64, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint64
K1_ARGS = [_P] * 3 + [_I64] + [_U64] * 4 + [_P] * 3 + [_I64, _P]
# form number in tools/step_forms.cu -> label
K1_FORMS = {1: "range_two_a_step", 2: "range_one_a_step", 3: "grid_sync", 4: "two_waves_atomic",
            5: "grid_stride", 6: "no_finish", 7: "moves_only", 8: "warp_chunk_128",
            9: "warp_chunk_512", 10: "range_two_atomic", 11: "range_one_atomic",
            12: "range_two_no_finish", 13: "range_two_moves", 14: "two_waves_moves",
            15: "prefetch_1_per_sm", 16: "prefetch_2_per_sm", 17: "smem_tile",
            18: "range_two_plain_loads", 19: "range_two_three_per_sm", 20: "stride_two",
            21: "stride_two_atomic", 22: "stride_one_atomic"}
K1_PROBES = ("no_finish", "moves_only", "range_two_no_finish", "range_two_moves",
             "two_waves_moves")
# (blocks an SM, chunks dealt round the blocks first) in tools/penalty_forms.cu -> label
PENALTY_FORMS = {(1, 0): "grid_1_per_sm", (2, 0): "grid_2_per_sm", (4, 0): "grid_4_per_sm",
                 (1, 1): "round_robin_1_per_sm", (2, 1): "round_robin_2_per_sm",
                 (4, 1): "round_robin_4_per_sm"}
PENALTY_ARGS = [_P] * 3 + [_I64, _U64, _P, _P]
# the earlier launchers: (library, function, argument types)
PARENT = {"k1": ("chain_parent", "chain_step_shard_launch", [_P] * 3 + [_I64] + [_U64] * 4
                 + [_P] * 4),
          "penalties": ("penalties_parent", "inactivity_penalties_launch", PENALTY_ARGS)}
TOTAL_WORDS = 1 + epoch.MASKED_SUMS_BLOCKS
PROGRAM_LIBRARIES = ("chain_step", "altair_sweeps", "sweeps")
KERNELS = ("chain_step_shard_kernel", "form_kernel", "inactivity_penalties_kernel",
           "flag_deltas_kernel", "effective_balance_kernel")


def _builds(parent: str | None) -> dict:
    jobs = {"step_forms": (os.path.join(ROOT, "tools", "step_forms.cu"), CSRC),
            "penalty_forms": (os.path.join(ROOT, "tools", "penalty_forms.cu"), CSRC)}
    if parent:
        pcsrc = os.path.join(parent, "ethereum_consensus_tpu_torch", "csrc")
        jobs["chain_parent"] = (os.path.join(pcsrc, "chain_step.cu"), pcsrc)
        jobs["penalties_parent"] = (os.path.join(pcsrc, "altair_sweeps.cu"), pcsrc)
        jobs["sweeps_parent"] = (os.path.join(pcsrc, "sweeps.cu"), pcsrc)
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(jobs) + 1) as pool:
        program = pool.submit(_kernels.build_all, PROGRAM_LIBRARIES)
        futures = {name: pool.submit(_build, name, *job) for name, job in jobs.items()}
        out = {name: f.result() for name, f in futures.items()}
        program.result()
    builds = {name: (_kernels._paths(name)[0], _kernels.build_log(name))
              for name in PROGRAM_LIBRARIES}
    builds.update(out)
    report = {}
    for name, (path, log) in builds.items():
        report[name] = {"ptxas": _kept(_ptxas_lines(log)), "sass": _kept(_sass(path))}
        print(f"  {name}: ptxas {report[name]['ptxas']}; SASS {report[name]['sass']}")
    return out, report


def _kept(by_kernel: dict) -> dict:
    """The entries of K1's and the penalties' kernels and their forms, each
    under its name and template arguments."""
    out = {}
    for kernel, value in by_kernel.items():
        for name in KERNELS:
            at = kernel.find(name)
            if at < 0:
                continue
            start = at
            while start > 0 and (kernel[start - 1].islower() or kernel[start - 1] == "_"):
                start -= 1
            args = re.match(r"(I\w+?E)E", kernel[at + len(name):])
            out[kernel[start:at + len(name)] + (args.group(1) if args else "")] = value
            break
    return out


def _mismatches(got, want) -> int:
    return sum(int((g != w).sum()) for g, w in zip(got, want))


def _time(candidates: dict, probes: tuple, want, nbytes: int) -> dict:
    """Each candidate checked twice against ``want`` (a form that carried
    a word across calls would fail the second), then timed in turns with
    the kernel, with a copy of ``nbytes`` bytes and an empty launch."""
    errs = {name: sum(_mismatches(fn(), want) for _ in range(2))
            for name, fn in candidates.items() if name not in probes}
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    candidates = {**candidates, "copy": lambda: dst.copy_(src),
                  "empty": lambda: torch.cuda._sleep(0)}
    times = {"write_flush": _turns(candidates, reps=30),
             "read_flush": _turns(candidates, reps=30, timer=_cuda_ms_clean)}
    return {"errs": errs, "ms": times}


def k1(libs: dict, n: int) -> dict:
    bal, eff, act = (chip_smoke._cuda_column(c) for c in chip_smoke._chain_columns(n, seed=n))
    hysteresis = sweeps.hysteresis_scalars(Context.for_mainnet())
    want = chain_step.chain_step_shard_plain(bal, eff, act, hysteresis)
    forms = _bind(libs["step_forms"][0], {"step_form_launch": [_I] + K1_ARGS})
    candidates = {"kernel": lambda: chain_step._launch_chain(bal, eff, act, hysteresis)}

    def outputs():
        return (torch.empty_like(bal), torch.empty((8, n // 4), dtype=torch.int32, device="cuda"),
                torch.empty(TOTAL_WORDS, dtype=torch.int64, device="cuda"))

    for form, label in K1_FORMS.items():
        new_eff, words, total = outputs()

        def run(form=form, label=label, new_eff=new_eff, words=words, total=total):
            rc = forms.step_form_launch(form, bal.data_ptr(), eff.data_ptr(), act.data_ptr(), n,
                                        *hysteresis, new_eff.data_ptr(), words.data_ptr(),
                                        total.data_ptr(), TOTAL_WORDS, _stream())
            if rc != 0:
                raise RuntimeError(f"K1 form {label} failed: {rc}")
            return new_eff, words, total[:1]
        candidates[label] = run
    name, fn_name, argtypes = PARENT["k1"]
    if name in libs:
        old = _bind(libs[name][0], {fn_name: argtypes})
        new_eff, words, total = outputs()

        def parent(new_eff=new_eff, words=words, total=total):
            rc = getattr(old, fn_name)(bal.data_ptr(), eff.data_ptr(), act.data_ptr(), n,
                                       *hysteresis, new_eff.data_ptr(), words.data_ptr(),
                                       total.data_ptr(), _stream())
            if rc != 0:
                raise RuntimeError(f"parent {fn_name} failed: {rc}")
            return new_eff, words, total[:1]
        candidates["parent"] = parent
    out = _time(candidates, K1_PROBES, want, n * chip_smoke.CHAIN_STEP_BYTES)
    print(f"K1 at n={n}: words unlike the plain version {out['errs']}; ms {out['ms']}")
    return out


def penalties(libs: dict, n: int) -> dict:
    c = chip_smoke._altair_columns(n, torch.Generator(device="cuda").manual_seed(n + 15))
    cols = (c["eff"], c["scores"], c["eligible"] & ~c["participating"])
    denominator = chip_smoke.ALTAIR_BIAS * chip_smoke.ALTAIR_QUOTIENT
    want = (sweeps.inactivity_penalties_plain(*cols, denominator),)
    forms = _bind(libs["penalty_forms"][0], {"penalty_form_launch": [_I, _I] + PENALTY_ARGS})
    candidates = {"kernel": lambda: (sweeps._launch_inactivity_penalties(*cols, denominator),)}
    for (blocks_per_sm, round_robin), label in PENALTY_FORMS.items():
        out = torch.empty_like(cols[0])

        def run(blocks_per_sm=blocks_per_sm, round_robin=round_robin, label=label, out=out):
            rc = forms.penalty_form_launch(blocks_per_sm, round_robin,
                                           *(t.data_ptr() for t in cols), n, denominator,
                                           out.data_ptr(), _stream())
            if rc != 0:
                raise RuntimeError(f"penalty form {label} failed: {rc}")
            return (out,)
        candidates[label] = run
    name, fn_name, argtypes = PARENT["penalties"]
    if name in libs:
        old = _bind(libs[name][0], {fn_name: argtypes})
        out = torch.empty_like(cols[0])

        def parent(out=out):
            rc = getattr(old, fn_name)(*(t.data_ptr() for t in cols), n, denominator,
                                       out.data_ptr(), _stream())
            if rc != 0:
                raise RuntimeError(f"parent {fn_name} failed: {rc}")
            return (out,)
        candidates["parent"] = parent
    result = _time(candidates, (), want, n * chip_smoke.INACTIVITY_PENALTIES_BYTES)
    print(f"penalties at n={n}: words unlike the plain version {result['errs']}; "
          f"ms {result['ms']}")
    return result


def unchanged(libs: dict, n: int) -> dict:
    """The flag deltas and B5-hysteresis beside the parent's builds of the
    same code, on chip_smoke's columns (no forms)."""
    c = chip_smoke._altair_columns(n, torch.Generator(device="cuda").manual_seed(n + 16))
    eff, part, elig = c["eff"], c["participating"], c["eligible"]
    flag_args = (chip_smoke.ALTAIR_TOTAL_ACTIVE, chip_smoke.ALTAIR_WEIGHTS[1],
                 chip_smoke.ALTAIR_INCREMENT, chip_smoke.ALTAIR_BRF, chip_smoke.ALTAIR_WD, 0, 0)
    flags_want = sweeps.flag_deltas_plain(eff, part, elig, *flag_args[:5], False, False)
    bal, old_eff, _ = (chip_smoke._cuda_column(col) for col in chip_smoke._chain_columns(n, n))
    hysteresis = sweeps.hysteresis_scalars(Context.for_mainnet())
    hyst_want = (sweeps.effective_balance_updates_plain(bal, old_eff, Context.for_mainnet()),)
    flags = {"kernel": lambda: sweeps._launch_flag_deltas(eff, part, elig, flag_args)}
    hyst = {"kernel": lambda: (sweeps._launch(bal, old_eff, hysteresis),)}
    if "penalties_parent" in libs:
        argtypes = _kernels._LIBRARIES["altair_sweeps"][1]["flag_deltas_launch"][0]
        old = _bind(libs["penalties_parent"][0], {"flag_deltas_launch": argtypes})
        rewards, penalties = torch.empty_like(eff), torch.empty_like(eff)
        scratch = torch.empty(sweeps.FLAG_DELTAS_SCRATCH_WORDS, dtype=torch.int64, device="cuda")

        def flags_parent():
            rc = old.flag_deltas_launch(eff.data_ptr(), part.data_ptr(), elig.data_ptr(), n,
                                        *flag_args, scratch.data_ptr(), scratch.shape[0],
                                        rewards.data_ptr(), penalties.data_ptr(), _stream())
            if rc != 0:
                raise RuntimeError(f"parent flag deltas failed: {rc}")
            return rewards, penalties
        flags["parent"] = flags_parent
    if "sweeps_parent" in libs:
        argtypes = _kernels._LIBRARIES["sweeps"][1]["effective_balance_launch"][0]
        old_sweeps = _bind(libs["sweeps_parent"][0], {"effective_balance_launch": argtypes})
        out = torch.empty_like(bal)

        def hyst_parent():
            rc = old_sweeps.effective_balance_launch(bal.data_ptr(), old_eff.data_ptr(), n,
                                                     *hysteresis, out.data_ptr(), _stream())
            if rc != 0:
                raise RuntimeError(f"parent hysteresis failed: {rc}")
            return (out,)
        hyst["parent"] = hyst_parent
    result = {"flag_deltas": _time(flags, (), flags_want, n * chip_smoke.FLAG_DELTAS_BYTES),
              "hysteresis": _time(hyst, (), hyst_want,
                                  n * chip_smoke.SWEEPS_BYTES_PER_VALIDATOR)}
    print(f"unchanged kernels at n={n}: {result}")
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a tree of the commit before these designs")
    parser.add_argument("--json", help="a file to write every result to")
    args = parser.parse_args()
    report = {"device": chip_smoke.phase_device()}
    libs, report["builds"] = _builds(args.parent)
    for n in SIZES:
        report[f"k1_{n}"] = k1(libs, n)
        report[f"penalties_{n}"] = penalties(libs, n)
        for name, result in unchanged(libs, n).items():
            report[f"{name}_{n}"] = result
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    bad = [k for k, v in report.items() if isinstance(v, dict) and any(v.get("errs", {}).values())]
    if bad:
        print(f"step_penalty_forms: a form disagrees with the plain version: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
