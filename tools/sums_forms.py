"""K2 (the epoch step's four sums, csrc/chain_step.cu) and the B9-epoch flag
sums (csrc/fused_epoch.cu), both csrc/masked_sums.h's kernel, beside their
measured alternatives and the earlier designs, on one card and the same
seeded columns: every form checked bit-exact against its plain version,
then timed with chip_smoke's CUDA-event timer in turns (kernel, form, form,
kernel), after its write flush and after a read flush.

    python3 tools/sums_forms.py [--parent DIR] [--json PATH]   # repo root, CUDA machine

At 2^20 validators and at 2^18 (a 4-shard share). The forms
(``tools/sums_forms.cu``): 16 validators a step against the kernel's 8, a
last-block ticket (its word zeroed each call, and reset by the last block
instead), and the earlier finish (the words zeroed, one atomic a block) on
the new loads. With ``--parent DIR``, a tree of the commit before this
design (``git archive`` of it unpacked there), its ``fused_epoch.cu`` and
``chain_step.cu`` are built from DIR and their sums timed beside the
program's. A ``torch.sum`` over an int64 view of as many bytes as each
kernel reads is the floor under this timer for a reduction of those bytes;
an empty launch (``torch.cuda._sleep(0)``) is the timer's own floor.
Each build's registers, frame and spills and each kernel's SASS
instructions and local-memory accesses are printed; ``--json`` also writes
every result to PATH. The forms and the earlier designs are measurements,
not part of the program.
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

SIZES = (1 << 20, 1 << 18)
CSRC = os.path.join(ROOT, "ethereum_consensus_tpu_torch", "csrc")
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
FORM_ARGS = [_I, _I] + [_P] * 5 + [_I64, _P, _I64, _P]
# form number in tools/sums_forms.cu -> label
FORMS = {1: "step16", 2: "ticket", 3: "ticket_reset", 4: "memset_atomic", 5: "warp_layout",
         6: "sync_only", 7: "no_finish", 8: "ldg", 9: "finish_loop", 10: "split_barrier",
         11: "empty_grid", 12: "coop_empty", 13: "block512", 14: "block1024",
         15: "sync_only_1024"}
# probes that compute no sums: timed, not checked
PROBES = ("sync_only", "no_finish", "empty_grid", "coop_empty", "sync_only_1024")
# the earlier launchers: the sums in words they zero
PARENT = {3: ("fused_parent", "fused_flag_sums_launch", [_P] * 4 + [_I64] + [_P] * 2),
          4: ("chain_parent", "epoch_step_sums_launch", [_P] * 5 + [_I64] + [_P] * 2)}
WORDS = 4 * (1 + epoch.MASKED_SUMS_BLOCKS) + 1
# bytes a kernel reads a validator: a word and K - 1 byte columns, as
# chip_smoke counts them
READ_BYTES = {3: chip_smoke.FLAG_SUMS_BYTES, 4: chip_smoke.EPOCH_SUMS_BYTES}


def _builds(parent: str | None) -> dict:
    jobs = {"sums_forms": (os.path.join(ROOT, "tools", "sums_forms.cu"), CSRC)}
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
    for name, (path, log) in builds.items():
        print(f"  {name}: ptxas {_kept(_ptxas_lines(log))}; SASS {_kept(_sass(path))}")
    return out


def _kept(by_kernel: dict) -> dict:
    """The entries of the sums' kernels, each under a short name."""
    out = {}
    for kernel, value in by_kernel.items():
        match = re.search(r"\d((?:masked_sums|form|ticket|atomic|warp_layout|no_finish|sync_only|"
                          r"flag_sums|epoch_step_sums)_kernel)(?:I(\w+?)E)?E", kernel)
        if match:
            out[match.group(1) + (f"<{match.group(2)}>" if match.group(2) else "")] = value
    return out


def _ptxas_lines(log: str) -> dict:
    """Registers, frame and spills of each kernel of a build's log, under
    its mangled name."""
    out, current = {}, None
    for line in log.splitlines():
        match = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if match:
            current = match.group(1)
            continue
        if current:
            for key, pattern in (("frame", r"(\d+) bytes stack frame"),
                                 ("spill", r"(\d+) bytes spill stores"),
                                 ("registers", r"Used (\d+) registers")):
                found = re.search(pattern, line)
                if found:
                    out.setdefault(current, {})[key] = int(found.group(1))
    return out


def _sass(lib_path: str) -> dict:
    """Per kernel of a built library, under its mangled name: its SASS
    instructions and local-memory loads and stores."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True).stdout
    out, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = line.split("Function :")[1].strip()
            out[current] = {"instructions": 0, "LDL": 0, "STL": 0}
        elif current and line.strip().startswith("/*") and "*/" in line and \
                line.strip()[2:6].strip("0123456789abcdef") == "":
            out[current]["instructions"] += 1
            for op in ("LDL", "STL"):
                out[current][op] += f" {op}" in line
    return out


def sums(libs: dict, n: int, k: int) -> dict:
    cols = chip_smoke._sums_columns(n, seed=n + k)
    kcols = cols if k == 4 else cols[:4]
    if k == 4:
        want = chain_step.epoch_step_sums_plain(*kcols)
        kernel = lambda: chain_step._launch_sums(kcols)  # noqa: E731
    else:
        want = epoch.fused_flag_sums_plain(*kcols)
        kernel = lambda: epoch.fused_flag_sums_cuda(*kcols)  # noqa: E731
    forms = _bind(libs["sums_forms"][0], {"sums_form_launch": FORM_ARGS})
    active_cur = cols[4].data_ptr() if k == 4 else None
    candidates = {"kernel": kernel}
    for form, label in FORMS.items():
        # the reset ticket keeps its words across calls: zeroed once here
        words = (torch.zeros if form == 3 else torch.empty)(WORDS, dtype=torch.int64,
                                                              device="cuda")

        def run(form=form, words=words, label=label):
            rc = forms.sums_form_launch(form, k, *(t.data_ptr() for t in cols[:4]), active_cur,
                                        n, words.data_ptr(), WORDS, _stream())
            if rc != 0:
                raise RuntimeError(f"form {label} failed: {rc}")
            return words[:k]
        candidates[label] = run
    if PARENT[k][0] in libs:
        name, fn_name, argtypes = PARENT[k]
        old = _bind(libs[name][0], {fn_name: argtypes})
        out = torch.empty(k, dtype=torch.int64, device="cuda")

        def parent(old=old, fn_name=fn_name, out=out):
            rc = getattr(old, fn_name)(*(t.data_ptr() for t in kcols), n, out.data_ptr(),
                                       _stream())
            if rc != 0:
                raise RuntimeError(f"parent {fn_name} failed: {rc}")
            return out
        candidates["parent"] = parent
    errs = {}
    for name, fn in candidates.items():
        if name in PROBES:
            continue
        # twice: a form that carries a word across calls must hold on the second
        errs[name] = sum(int((fn() != want).sum()) for _ in range(2))
    view = torch.empty(n * READ_BYTES[k] // 8, dtype=torch.int64, device="cuda")
    candidates["torch_sum"] = lambda: view.sum()
    times = {"write_flush": _turns(candidates, reps=30),
             "read_flush": _turns(candidates, reps=30, timer=_cuda_ms_clean)}
    label = "K2" if k == 4 else "flag sums"
    print(f"{label} at n={n}: words unlike the plain version {errs}; ms {times}")
    return {"errs": errs, "ms": times}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a tree of the commit before this design")
    parser.add_argument("--json", help="a file to write every result to")
    args = parser.parse_args()
    report = {"device": chip_smoke.phase_device()}
    libs = _builds(args.parent)
    forms = _bind(libs["sums_forms"][0], {})
    forms.sums_forms_split_barrier.restype = ctypes.c_int
    report["split_barrier"] = bool(forms.sums_forms_split_barrier())
    print(f"the split grid barrier (barrier_arrive, barrier_wait) in this toolkit: "
          f"{report['split_barrier']}")
    for n in SIZES:
        for k in (4, 3):
            report[f"{'k2' if k == 4 else 'flag_sums'}_{n}"] = sums(libs, n, k)
    report["timer_floor_ms"] = chip_smoke._cuda_ms(lambda: torch.cuda._sleep(0), reps=50,
                                                   warmup=5)
    print(f"the timer's floor (an empty launch) {1e3 * report['timer_floor_ms']:.2f} us")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    bad = [k for k, v in report.items() if isinstance(v, dict) and any(v.get("errs", {}).values())]
    if bad:
        print(f"sums_forms: a form disagrees with the plain version: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
