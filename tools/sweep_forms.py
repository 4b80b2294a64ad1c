"""B5-hysteresis (csrc/sweeps.cu) and B5-altair's inactivity updates
(csrc/altair_sweeps.cu) on the warp chunks beside their parent design
(tools/sweep_parent_forms.cu: one validator a thread, the hysteresis floor a
software 64-bit remainder), on one card and the same seeded columns: each
kernel and each parent checked bit-exact against its plain version, then
timed with chip_smoke's CUDA-event timer in turns (kernel, parent, parent,
kernel), after its write flush and after a read flush, beside a PyTorch copy
of as many bytes as the kernel moves (half read, half written) and an empty
launch (``torch.cuda._sleep(0)``).

    python3 tools/sweep_forms.py [--forms] [--json PATH]   # repo root, CUDA machine

At 2^20 validators (the registry), 2^19, 2^18 (a 4-shard share) and 2^21 + 5
(the last 5 validators go one a thread). Each build's
registers, frame and spills (ptxas) and each kernel's SASS instructions and
local-memory accesses are printed and kept, with those of the kernels that
share their headers; ``--json`` also writes every result to PATH. With
``--forms`` the measured alternatives of ``tools/sweep_step_forms.cu``
(warp chunks of 1, 2, 4 and 8 steps, for the updates the program's kernel at
each count whatever its launcher would take, the leak state a template
argument, the update lane as selects, and probes that store the words as
read, not checked) join the turns. A lane shared with B3 and K3
(``altair_core::inactivity_update``) is timed against an earlier tree's
builds with ``tools/epoch_forms.py --parent``. ``chip_smoke.py`` builds the parents
with ``build_parents`` in its build phase and calls ``hysteresis`` and
``updates`` at 2^20 and 2^18 in its ``sweeps`` and ``altair_sweeps``
phases. The parents and forms are measurements, not part of the program.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from ethereum_consensus_tpu_torch import _kernels  # noqa: E402
from ethereum_consensus_tpu_torch.config import Context  # noqa: E402
from ethereum_consensus_tpu_torch.ops import sweeps  # noqa: E402
from tools.merkle_flag_forms import _build, _cuda_ms_clean, _stream, _turns  # noqa: E402
from tools.sums_forms import _ptxas_lines, _sass  # noqa: E402

SIZES = (1 << 20, 1 << 19, 1 << 18, (1 << 21) + 5)
CSRC = os.path.join(ROOT, "ethereum_consensus_tpu_torch", "csrc")
PARENT_SOURCE = os.path.join(ROOT, "tools", "sweep_parent_forms.cu")
FORMS_SOURCE = os.path.join(ROOT, "tools", "sweep_step_forms.cu")
PROGRAM_LIBRARIES = ("sweeps", "altair_sweeps", "chain_step", "fused_epoch")
KERNELS = ("effective_balance_kernel", "inactivity_updates_kernel", "form_kernel",
           "flag_deltas_kernel", "inactivity_penalties_kernel", "chain_step_shard_kernel",
           "fused_epoch_kernel", "apply_kernel")
# the parent's launchers, with the program's C interfaces
PARENT_FUNCTIONS = {"effective_balance_launch": "sweeps",
                    "inactivity_updates_launch": "altair_sweeps"}
TIMING_REPS = 30
# tools/sweep_step_forms.cu: the updates' form number -> label, the probes
# among them; hysteresis' steps (0 the probe) -> label
UPDATE_FORMS = {1: "steps_4_leak_template", 2: "steps_2", 3: "steps_1",
                4: "steps_2_leak_template", 5: "moves_only", 6: "steps_8",
                7: "steps_4_select", 8: "steps_2_select", 9: "steps_1_select", 10: "steps_4"}
HYSTERESIS_FORMS = {1: "steps_1", 2: "steps_2", 8: "steps_8", 0: "moves_only"}
PROBES = ("moves_only",)
_P, _I, _I64, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint64


def build_parents(forms: bool = False) -> dict:
    """{"sweep_parents": (library, ptxas log)}: the parent forms, built with
    the program's flags against csrc/; with ``forms`` also "sweep_forms",
    the measured alternatives, built at once."""
    jobs = {"sweep_parents": PARENT_SOURCE}
    if forms:
        jobs["sweep_forms"] = FORMS_SOURCE
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = {name: pool.submit(_build, name, source, CSRC) for name, source in jobs.items()}
        return {name: f.result() for name, f in futures.items()}


def _parent_lib(libs: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(libs["sweep_parents"][0])
    for fn, library in PARENT_FUNCTIONS.items():
        argtypes, restype = _kernels._LIBRARIES[library][1][fn]
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def _kept(table: dict) -> dict:
    return {k: v for k, v in table.items() if any(kernel in k for kernel in KERNELS)}


def compiled(libs: dict) -> dict:
    """Registers, frame and spills (ptxas) and SASS instructions and local
    accesses of the two kernels and of the kernels that share their headers
    (the flag deltas, the penalties, K1, B3, the apply entries, K3), in the
    program's builds, the parents' and the forms'."""
    logs = {name: (_kernels._paths(name)[0], _kernels.build_log(name))
            for name in PROGRAM_LIBRARIES}
    logs.update(libs)
    return {name: {"ptxas": _kept(_ptxas_lines(log)), "sass": _kept(_sass(path))}
            for name, (path, log) in logs.items()}


def _time(candidates: dict, want: tuple, nbytes: int) -> dict:
    """Each candidate checked twice against ``want`` (a form that carried a
    word across calls would fail the second), then timed in turns with the
    kernel, with a copy of ``nbytes`` bytes and an empty launch, after the
    write flush and after a read flush."""
    errs = {name: sum(int((got != w).sum()) for _ in range(2) for got, w in zip(fn(), want))
            for name, fn in candidates.items() if name not in PROBES}
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    candidates = {**candidates, "copy": lambda: dst.copy_(src),
                  "empty": lambda: torch.cuda._sleep(0)}
    times = {"write_flush": _turns(candidates, reps=TIMING_REPS),
             "read_flush": _turns(candidates, reps=TIMING_REPS, timer=_cuda_ms_clean)}
    return {"errs": errs, "ms": times}


def hysteresis(libs: dict, n: int) -> dict:
    """B5-hysteresis and its parent on chip_smoke's hysteresis columns."""
    ctx = Context.for_mainnet()
    scalars = sweeps.hysteresis_scalars(ctx)
    gen = torch.Generator(device="cuda").manual_seed(n + 18)
    bal, eff = chip_smoke._hysteresis_columns(n, gen, scalars)
    want = (sweeps.effective_balance_updates_plain(bal, eff, ctx),)
    parent_lib = _parent_lib(libs)
    out = torch.empty_like(bal)

    def parent():
        rc = parent_lib.effective_balance_launch(bal.data_ptr(), eff.data_ptr(), n, *scalars,
                                                 out.data_ptr(), _stream())
        if rc != 0:
            raise RuntimeError(f"parent hysteresis failed: CUDA error {rc}")
        return (out,)

    candidates = {"kernel": lambda: (sweeps._launch(bal, eff, scalars),), "parent": parent}
    if "sweep_forms" in libs:
        forms = ctypes.CDLL(libs["sweep_forms"][0])
        forms.hysteresis_form_launch.argtypes = [_I, _P, _P, _I64] + [_U64] * 4 + [_P, _P]
        forms.hysteresis_form_launch.restype = _I
        for steps, label in HYSTERESIS_FORMS.items():
            form_out = torch.empty_like(bal)

            def run(steps=steps, label=label, form_out=form_out):
                rc = forms.hysteresis_form_launch(steps, bal.data_ptr(), eff.data_ptr(), n,
                                                  *scalars, form_out.data_ptr(), _stream())
                if rc != 0:
                    raise RuntimeError(f"hysteresis form {label} failed: CUDA error {rc}")
                return (form_out,)
            candidates[label] = run
    result = _time(candidates, want, n * chip_smoke.SWEEPS_BYTES_PER_VALIDATOR)
    print(f"hysteresis at n={n}: words unlike the plain version {result['errs']}; "
          f"ms {result['ms']}")
    return result


def updates(libs: dict, n: int) -> dict:
    """The inactivity updates and their parent on chip_smoke's altair
    columns, not leaking (the recovery step runs)."""
    c = chip_smoke._altair_columns(n, torch.Generator(device="cuda").manual_seed(n + 19))
    cols = (c["scores"], c["participating"], c["eligible"])
    scalars = (chip_smoke.ALTAIR_BIAS, chip_smoke.ALTAIR_RECOVERY, 0)
    want = (sweeps.inactivity_updates_plain(*cols, *scalars[:2], False),)
    parent_lib = _parent_lib(libs)
    out = torch.empty_like(cols[0])

    def parent():
        rc = parent_lib.inactivity_updates_launch(*(t.data_ptr() for t in cols), n, *scalars,
                                                  out.data_ptr(), _stream())
        if rc != 0:
            raise RuntimeError(f"parent inactivity updates failed: CUDA error {rc}")
        return (out,)

    candidates = {"kernel": lambda: (sweeps._launch_inactivity_updates(*cols, scalars),),
                  "parent": parent}
    if "sweep_forms" in libs:
        forms = ctypes.CDLL(libs["sweep_forms"][0])
        forms.update_form_launch.argtypes = [_I, _P, _P, _P, _I64, _U64, _U64, _I, _P, _P]
        forms.update_form_launch.restype = _I
        for form, label in UPDATE_FORMS.items():
            form_out = torch.empty_like(cols[0])

            def run(form=form, label=label, form_out=form_out):
                rc = forms.update_form_launch(form, *(t.data_ptr() for t in cols), n, *scalars,
                                              form_out.data_ptr(), _stream())
                if rc != 0:
                    raise RuntimeError(f"update form {label} failed: CUDA error {rc}")
                return (form_out,)
            candidates[label] = run
    result = _time(candidates, want, n * chip_smoke.INACTIVITY_UPDATES_BYTES)
    print(f"inactivity updates at n={n}: words unlike the plain version {result['errs']}; "
          f"ms {result['ms']}")
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="a file to write every result to")
    parser.add_argument("--forms", action="store_true",
                        help="time the measured alternatives of tools/sweep_step_forms.cu too")
    args = parser.parse_args()
    report = {"device": chip_smoke.phase_device()}
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        program = pool.submit(_kernels.build_all, PROGRAM_LIBRARIES)
        libs = build_parents(args.forms)
        program.result()
    report["compiled"] = compiled(libs)
    for name, table in report["compiled"].items():
        print(f"  {name}: ptxas {table['ptxas']}; SASS {table['sass']}")
    for n in SIZES:
        report[f"hysteresis_{n}"] = hysteresis(libs, n)
        report[f"updates_{n}"] = updates(libs, n)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    bad = [k for k, v in report.items() if isinstance(v, dict) and any(v.get("errs", {}).values())]
    if bad:
        print(f"sweep_forms: a kernel or a parent disagrees with the plain version: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
