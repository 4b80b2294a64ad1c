"""B3 (the fused altair epoch kernel, csrc/fused_epoch.cu), its two apply
entries and K3 (the epoch step's element pass, csrc/chain_step.cu) beside
their earlier designs and a copy of the same bytes, on one card and the same
seeded inputs: every kernel checked bit-exact against its plain version (the
census too), then timed with chip_smoke's CUDA-event timer in turns
(kernel, earlier design, earlier design, kernel).

    python3 tools/epoch_forms.py [--parent DIR] [--json PATH]   # repo root, CUDA machine

At 2^20 validators of mainnet-like columns (chip_smoke's ``_altair_columns``);
B3 also at 2^21 + 5, where a warp takes several chunks. With ``--parent
DIR``, a tree of the commit before these designs (``git archive`` of it
unpacked there), its B3, apply entries and K3 are built from DIR and timed
beside the program's. A PyTorch copy of as many bytes as the pass moves is
the bytes' floor under this timer; B3 and the copy are also timed with the
L2 flushed by a read (no dirty lines for the timed call to write back).
Each build's registers, frame and spills and each kernel's SASS
instructions and local-memory accesses are printed; ``--json`` also writes
every result to PATH. The earlier designs are measurements, not part of the
program.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from ethereum_consensus_tpu_torch import _kernels  # noqa: E402
from ethereum_consensus_tpu_torch.ops import chain_step, epoch  # noqa: E402
from tools.merkle_flag_forms import _bind, _build, _cuda_ms_clean, _stream, _turns  # noqa: E402

N = 1 << 20
WIDE_N = (1 << 21) + 5
# bytes the pass moves a validator: every input read once, every output
# written once
PASS_BYTES = 44
COLUMNS = ("balances", "eff", "prev_part", "slashed", "active_prev", "eligible", "scores")
_P, _I, _I64, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint64
# the earlier designs' launchers: the sums in a device scratch of four words
PARENT_FUSED_ARGS = [_P] * 7 + [_I64] + [_U64] * 10 + [_I] * 3 + [_P] * 4
PARENT_REWARDS_ARGS = [_P] * 7 + [_I64] + [_U64] * 8 + [_I] * 3 + [_P] * 3
STEP_ARGS = [_P] * 7 + [_I64] + [_U64] * 13 + [_I] * 3 + [_P] * 3


def _label(kernel: str) -> str:
    """A short name of a mangled kernel name."""
    match = re.search(r"apply_kernelILb(\d)ELb(\d)E", kernel)
    if match:
        return f"apply_kernel<{match.group(1)},{match.group(2)}>"
    match = re.search(r"(fused_epoch_kernel|epoch_step_apply_kernel)(ILb(\d)E)?", kernel)
    if match:
        return match.group(1) + (f"<{match.group(3)}>" if match.group(3) else "")
    return kernel[-32:]


def _ptxas(log: str) -> dict:
    """Registers, frame and spills of each kernel of a build's log."""
    out, current = {}, None
    for line in log.splitlines():
        match = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if match:
            current = _label(match.group(1))
            continue
        if current:
            for key, pattern in (("frame", r"(\d+) bytes stack frame"),
                                 ("spill", r"(\d+) bytes spill stores"),
                                 ("registers", r"Used (\d+) registers")):
                found = re.search(pattern, line)
                if found:
                    out.setdefault(current, {})[key] = int(found.group(1))
    return out


def _sass_counts(lib_path: str) -> dict:
    """Per kernel of a built library: its SASS instructions, and its local
    memory loads and stores."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True).stdout
    out, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = _label(line.split("Function :")[1].strip())
            out[current] = {"instructions": 0, "LDL": 0, "STL": 0}
        elif current and line.strip().startswith("/*") and "*/" in line and \
                line.strip()[2:6].strip("0123456789abcdef") == "":
            out[current]["instructions"] += 1
            for op in ("LDL", "STL"):
                out[current][op] += f" {op}" in line
    return out


def _builds(parent: str | None) -> dict:
    """The program's libraries and, with ``parent``, the earlier designs';
    prints each build's ptxas lines and SASS counts of the pass's kernels."""
    jobs = {}
    if parent:
        pcsrc = os.path.join(parent, "ethereum_consensus_tpu_torch", "csrc")
        jobs["fused_parent"] = (os.path.join(pcsrc, "fused_epoch.cu"), pcsrc)
        jobs["chain_parent"] = (os.path.join(pcsrc, "chain_step.cu"), pcsrc)
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(jobs) + 1) as pool:
        program = pool.submit(_kernels.build_all)
        futures = {name: pool.submit(_build, name, *job) for name, job in jobs.items()}
        out = {name: f.result() for name, f in futures.items()}
        program.result()
    builds = {name: (_kernels._paths(name)[0], _kernels.build_log(name))
              for name in ("fused_epoch", "chain_step")}
    builds.update(out)
    skip = ("flag_sums", "chain_step_shard", "epoch_step_sums")
    for name, (path, log) in builds.items():
        ptxas = {k: v for k, v in _ptxas(log).items() if not any(w in k for w in skip)}
        sass = {k: v for k, v in _sass_counts(path).items() if not any(w in k for w in skip)}
        print(f"  {name}: ptxas {ptxas}; SASS {sass}")
    return out


def _errs(candidates: dict, want: tuple) -> dict:
    """Each candidate's count of output words that differ from the plain
    version's, a census that differs counting one."""
    out = {}
    for name, fn in candidates.items():
        got = fn()
        torch.cuda.synchronize()
        out[name] = sum(int(int(g) != w) if isinstance(w, int) else int((g != w).sum())
                        for g, w in zip(got, want))
    return out


def floors(kernels: dict) -> dict:
    """A copy of the pass's bytes at 2^20 (PASS_BYTES a validator, half read
    and half written), and ``kernels`` and the copy timed with each flush."""
    src = torch.empty(PASS_BYTES // 2 * N, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    candidates = {"copy": lambda: dst.copy_(src), **kernels}
    out = {"write_flush": {k: chip_smoke._cuda_ms(fn, reps=30, warmup=3)
                           for k, fn in candidates.items()},
           "read_flush": {k: _cuda_ms_clean(fn, reps=30) for k, fn in candidates.items()}}
    print(f"floors at n={N} ({PASS_BYTES} bytes a validator): ms {out}")
    return out


def b3(libs: dict, n: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(13)
    c = chip_smoke._altair_columns(n, gen)
    cols = tuple(c[k] for k in COLUMNS)
    scalars = chip_smoke._fused_scalars(False)
    words = epoch._scalars(*scalars)
    want = epoch.fused_epoch_plain(*cols, *scalars)

    def kernel():
        s, b, w = epoch._launch(cols, words)
        return s, b, w[3]

    candidates = {"kernel": kernel}
    if "fused_parent" in libs:
        old = _bind(libs["fused_parent"][0], {"fused_epoch_launch": PARENT_FUSED_ARGS})
        scratch = torch.empty(4, dtype=torch.int64, device="cuda")
        scores, balances = torch.empty_like(cols[0]), torch.empty_like(cols[0])

        def parent():
            rc = old.fused_epoch_launch(*(t.data_ptr() for t in cols), n, *words,
                                        scratch.data_ptr(), scores.data_ptr(),
                                        balances.data_ptr(), _stream())
            if rc != 0:
                raise RuntimeError(f"parent launch failed: {rc}")
            return scores, balances, scratch[3]
        candidates["parent"] = parent
    errs = _errs(candidates, want)
    times = _turns(candidates, reps=30)
    print(f"B3 at n={n}: words unlike the plain version {errs} (census {want[2]}); ms {times}")
    out = {"errs": errs, "ms": times, "census": want[2]}
    if n == N:
        out["floors"] = floors(candidates)
    return out


def applies(libs: dict) -> dict:
    """The apply entries and K3, the program's against the parent's."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    c = chip_smoke._altair_columns(N, gen)
    cols = tuple(c[k] for k in COLUMNS)
    scalars = chip_smoke._fused_scalars(False)
    words = epoch._scalars(*scalars)
    rwords = words[:4] + words[6:]
    sums = epoch.fused_flag_sums_plain(*cols[1:5]).tolist()
    rcols = (*cols[:6], epoch.fused_epoch_plain(*cols, *scalars)[0])
    census = torch.empty(1, dtype=torch.int64, device="cuda")
    # K3 on the same columns, the previous epoch's actives as the current's
    consts = (chip_smoke.ALTAIR_INCREMENT, chip_smoke.ALTAIR_BRF, chip_smoke.ALTAIR_BIAS,
              chip_smoke.ALTAIR_RECOVERY, chip_smoke.ALTAIR_QUOTIENT, chip_smoke.ALTAIR_WEIGHTS,
              chip_smoke.ALTAIR_WD, False, 2, 1)
    step_sums = chain_step.epoch_step_sums_plain(*cols[1:5], cols[4]).tolist()
    step_args = chain_step.apply_args(step_sums, *consts)
    entries = {
        "fused_epoch_apply": (
            lambda: (*epoch._launch_apply("fused_epoch_apply_launch", "fused_epoch_apply", cols,
                                          sums, words, census, True), census[0]),
            epoch.fused_epoch_apply_plain(*cols, sums, *scalars), cols, words, 2),
        "rewards_apply": (
            lambda: (*epoch._launch_apply("rewards_apply_launch", "rewards_apply", rcols, sums,
                                          rwords, census, False)[1:], census[0]),
            epoch.rewards_apply_plain(*rcols, sums, *(scalars[:4] + scalars[6:])), rcols, rwords,
            1),
        "epoch_step_apply": (
            lambda: chain_step._launch_apply(cols, step_args),
            chain_step.epoch_step_apply_plain(*cols, step_sums, *consts), cols, step_args, 2),
    }
    out = {}
    for name, (kernel, want, ecols, ewords, n_out) in entries.items():
        candidates = {"kernel": kernel}
        step = name == "epoch_step_apply"
        lib = libs.get("chain_parent" if step else "fused_parent")
        if lib:
            fn_name = f"{name}_launch"
            old = _bind(lib[0], {fn_name: STEP_ARGS if step else
                                 PARENT_FUSED_ARGS if n_out == 2 else PARENT_REWARDS_ARGS})
            outs = [torch.empty_like(cols[0]) for _ in range(n_out)]
            # the earlier apply entries read the sums from a device scratch
            sums_scratch = () if step else (torch.tensor([*sums, 0], dtype=torch.int64,
                                                         device="cuda"),)

            def parent(old=old, fn_name=fn_name, outs=outs, ecols=ecols, ewords=ewords,
                       sums_scratch=sums_scratch, step=step):
                rc = getattr(old, fn_name)(*(t.data_ptr() for t in ecols), N, *ewords,
                                           *(t.data_ptr() for t in sums_scratch),
                                           *(t.data_ptr() for t in outs), _stream())
                if rc != 0:
                    raise RuntimeError(f"parent {fn_name} failed: {rc}")
                if step:
                    return outs[1], outs[0]  # (balances, scores), as the plain version
                return (*outs, sums_scratch[0][3])
            candidates["parent"] = parent
        errs = _errs(candidates, want)
        times = _turns(candidates, reps=30)
        print(f"{name} at n={N}: words unlike the plain version {errs}; ms {times}")
        out[name] = {"errs": errs, "ms": times}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a tree of the commit before these designs")
    parser.add_argument("--json", help="a file to write every result to")
    args = parser.parse_args()
    report = {"device": chip_smoke.phase_device()}
    libs = _builds(args.parent)
    report["b3"] = b3(libs, N)
    report["b3_wide"] = b3(libs, WIDE_N)
    report.update(applies(libs))
    tiny = torch.zeros(1, device="cuda")
    report["timer_floor_ms"] = chip_smoke._cuda_ms(lambda: tiny.add_(1), reps=50, warmup=5)
    print(f"the timer's floor (one one-element add) {1e3 * report['timer_floor_ms']:.2f} us")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    bad = [k for k, v in report.items() if isinstance(v, dict) and any(v.get("errs", {}).values())]
    if bad:
        print(f"epoch_forms: a kernel disagrees with the plain version: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
