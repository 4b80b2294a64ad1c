"""B8 and the mxu builds of B6 and B7 beside their parent design, on one card:
the field product of ``csrc/fp_mma.h`` against the byte-round reduction it
replaced (``tools/mxu_parent_fp_mma.h``, which every thread of a warp
repeats), B8's tile of 16 products a warp (``csrc/mont_mxu.cu``) against
its one-warp-a-product parent (``tools/mxu_forms.cu``).

    python3 tools/mxu_forms.py [--json PATH]   # repo root, CUDA machine

``build_parents()`` builds the parent forms: ``mont_mxu`` from
``tools/mxu_forms.cu``, and ``pairing_mxu`` and ``g1_sum_mxu`` from a copy
of ``csrc/`` whose ``fp_mma.h`` is the parent header, with the program's
flags. ``parent(libs, name)`` puts a parent library in the program's place
for the calls inside it, so the program's wrappers launch it with the same
arguments. ``chip_smoke.py`` times the program against the parents in its
``mxu``, ``g1`` and ``pairing`` phases. Run alone, this script is the
short check of a new design: B8 bit-exact against ``fq.mul`` at 2^20
products (with the edges) and at the tile edges, the four B7 kernels' mxu
builds limb-equal to the u64 kernels on a seeded batch, then CUDA-event
times of B8 at 2^20 and 2^15 and of the mxu Miller loop at the batch's 528
lanes, each in turns with its parent (program, parent, parent, program),
every build's ptxas lines, and B8's phase probes (``tools/mxu_probe_forms.cu``:
the products alone, the reduction alone, the loads and stores alone), each
in turns with the kernel. The parents and probes are measurements, not
part of the program.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ethereum_consensus_tpu_torch import _kernels  # noqa: E402

TOOLS = os.path.join(ROOT, "tools")
CSRC = os.path.join(ROOT, "ethereum_consensus_tpu_torch", "csrc")
PARENT_HEADER = os.path.join(TOOLS, "mxu_parent_fp_mma.h")
PARENT_LIBRARIES = ("mont_mxu", "pairing_mxu", "g1_sum_mxu")
B8_SIZES = (1 << 20, 1 << 15)
TILE_EDGES = (1, 15, 16, 17, (1 << 10) + 3)


def _nvcc(name: str, source: str, include: str, out_dir: str) -> tuple:
    lib = os.path.join(out_dir, f"lib{name}_parent.so")
    flags = _kernels._flags(name) if name in _kernels._LIBRARIES else _kernels.NVCC_FLAGS
    r = subprocess.run([_kernels._nvcc(), *flags, f"-I{include}", "-o", lib, source],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{name} parent: nvcc failed\n{r.stdout}{r.stderr}")
    return lib, r.stdout + r.stderr


def build_parents(probes: bool = False) -> dict:
    """{library: (path, ptxas log)} of the three parent forms, and with
    ``probes`` of B8's phase probes (``mont_mxu_probe``,
    tools/mxu_probe_forms.cu), built at once."""
    work = os.path.join(_kernels._BUILD, "forms", "mxu_parent")
    src = os.path.join(work, "csrc")
    os.makedirs(src, exist_ok=True)
    for name in os.listdir(CSRC):
        if name.endswith((".h", ".cu")):
            shutil.copy(os.path.join(CSRC, name), src)
    shutil.copy(PARENT_HEADER, os.path.join(src, "fp_mma.h"))
    jobs = {"mont_mxu": (os.path.join(TOOLS, "mxu_forms.cu"), CSRC),
            "pairing_mxu": (os.path.join(src, "pairing.cu"), src),
            "g1_sum_mxu": (os.path.join(src, "g1_sum.cu"), src)}
    if probes:
        jobs["mont_mxu_probe"] = (os.path.join(TOOLS, "mxu_probe_forms.cu"), CSRC)
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = {name: pool.submit(_nvcc, name, *job, work) for name, job in jobs.items()}
        return {name: f.result() for name, f in futures.items()}


def spill_table(lines: dict) -> dict:
    """{function: ((spill stores, frame), (the parent's))} over both builds'
    ptxas lines, each function's largest."""
    table: dict = {}
    for side, at in (("program", 0), ("parent", 1)):
        for line in lines[side]:
            pair = table.setdefault(line["kernel"].split("_cu_")[-1], [(0, 0), (0, 0)])
            here = (line.get("spill_stores", 0), line.get("stack_frame", 0))
            pair[at] = max(pair[at], here)
    return {k: tuple(v) for k, v in table.items()}


_BOUND: dict = {}


def _bind(name: str, path: str) -> ctypes.CDLL:
    if path in _BOUND:
        return _BOUND[path]
    lib = _BOUND[path] = ctypes.CDLL(path)
    for fn_name, (argtypes, restype) in _kernels._LIBRARIES[name][1].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


@contextlib.contextmanager
def parent(libs: dict, name: str):
    """The parent form of library ``name`` in the program's place."""
    _kernels.load(name)
    program = _kernels._LOADED[name]
    _kernels._LOADED[name] = _bind(name, libs[name][0])
    try:
        yield
    finally:
        _kernels._LOADED[name] = program


def in_turns(program, parent_fn, reps: int, warmup: int = 2) -> dict:
    """CUDA-event medians of the program and the parent in turns (program,
    parent, parent, program); each side's two readings."""
    import chip_smoke

    times = {"program": [], "parent": []}
    for side in ("program", "parent", "parent", "program"):
        fn = program if side == "program" else parent_fn
        times[side].append(chip_smoke._cuda_ms(fn, reps=reps, warmup=warmup))
    return times


PROBE_FORMS = ("products_alone", "reduction_alone", "loads_and_stores")


def probe_times(libs: dict) -> dict:
    """CUDA-event ms of B8's phase probes at each size, each in turns with
    the kernel."""
    import chip_smoke
    from ethereum_consensus_tpu_torch.ops import fq8

    probe = ctypes.CDLL(libs["mont_mxu_probe"][0])
    probe.mont_mxu_probe_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_void_p,
                                                                    ctypes.c_int, ctypes.c_void_p]
    probe.mont_mxu_probe_launch.restype = ctypes.c_int
    out = {}
    for n in B8_SIZES:
        a, b = _b8_operands(n, seed=n)
        result = torch.empty_like(a)
        stream = torch.cuda.current_stream().cuda_stream
        for form, label in enumerate(PROBE_FORMS):
            def run(form=form, a=a, b=b):
                rc = probe.mont_mxu_probe_launch(a.data_ptr(), b.data_ptr(), a.shape[0],
                                                 result.data_ptr(), form, stream)
                if rc:
                    raise RuntimeError(f"probe {label}: CUDA error {rc}")
            times = {"kernel": [], label: []}
            for side in ("kernel", label, label, "kernel"):
                fn = (lambda a=a, b=b: fq8.mont7r_cuda(a, b)) if side == "kernel" else run
                times[side].append(chip_smoke._cuda_ms(fn, reps=10))
            out[f"b8_{n}_{label}"] = times
    return out


def _b8_operands(n: int, seed: int):
    import chip_smoke

    return chip_smoke._mont_operands(n, torch.Generator(device="cuda").manual_seed(seed))


def main() -> int:
    import chip_smoke
    from ethereum_consensus_tpu_torch.ops import fq, fq8, pairing

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="write every result here")
    args = ap.parse_args()
    report = {"device": chip_smoke.phase_device()}
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        parents_f = pool.submit(build_parents, True)
        _kernels.build_all(("mont_mxu", "pairing_mxu", "g1_sum_mxu", "pairing", "g1_sum"))
        libs = parents_f.result()
    report["ptxas"] = {}
    for name in PARENT_LIBRARIES:
        report["ptxas"][name] = {
            "program": chip_smoke._ptxas_lines(name, "", _kernels.build_log(name)),
            "parent": chip_smoke._ptxas_lines(name, "", libs[name][1]),
            "sass": {"program": chip_smoke._sass_instructions(name),
                     "parent": chip_smoke._sass_instructions(name, libs[name][0])}}
        print(f"{name}: {json.dumps(report['ptxas'][name])}")
        print(f"{name} (program, parent): " + "; ".join(
            f"{k[-40:]} {v}" for k, v in spill_table(report["ptxas"][name]).items()))

    # B8: bit-exact at 2^20 with the edges and at the tile edges
    errs = {}
    for n in (*B8_SIZES, *TILE_EDGES):
        a, b = _b8_operands(n, seed=n)
        got = fq8.mont7r(a, b)
        torch.cuda.synchronize()
        want = fq.limbs32(fq.mul(fq.limbs16(a), fq.limbs16(b)))
        with parent(libs, "mont_mxu"):
            parent_out = fq8.mont7r(a, b)
        errs[n] = (chip_smoke._max_err(got, want), chip_smoke._max_err(parent_out, want))
    print(f"B8 max_abs_err (program, parent) vs fq.mul by n: {errs}")
    report["b8_errors"] = errs
    if any(e != (0, 0) for e in errs.values()):
        print("mxu_forms: B8 disagrees")
        return 1

    # B7's mxu builds against the u64 kernels on a seeded batch
    n_max = 528
    batch = chip_smoke._pairing_batch(n_max, seed=381)
    words = pairing.scalar_words(batch["scalars"], "cuda")
    pk = torch.stack(pairing.g1_affine_from_raw(batch["pk"], "cuda"), dim=1).contiguous()
    sig = torch.stack(pairing.g2_affine_from_raw(batch["sig"], "cuda"), dim=1).contiguous()
    xq, yq = (v.contiguous() for v in pairing.g2_affine_from_raw(batch["h"], "cuda"))
    u64 = {}
    plain_pk = pairing.g1_mul_affine(pk, words)
    xp, yp = plain_pk[:, 0].contiguous(), plain_pk[:, 1].contiguous()
    wide = (xp, yp, xq, yq)
    for n in (1, 2, 3, 64, n_max):
        f = pairing.miller_loop(xp[:n], yp[:n], xq[:n], yq[:n])
        u64[n] = (pairing.g1_mul_affine(pk[:n], words[:n]), pairing.g2_mul_sum(sig[:n], words[:n]),
                  f, pairing.fp12_product(f))
    torch.cuda.synchronize()
    mxu_errs = {}
    fq8.set_multiplier("mxu")
    try:
        for n, want in u64.items():
            f = pairing.miller_loop(xp[:n], yp[:n], xq[:n], yq[:n])
            got = (pairing.g1_mul_affine(pk[:n], words[:n]), pairing.g2_mul_sum(sig[:n], words[:n]),
                   f, pairing.fp12_product(f))
            torch.cuda.synchronize()
            mxu_errs[n] = [chip_smoke._max_err(g, w) for g, w in zip(got, want)]
        print(f"B7 mxu builds max_abs_err vs u64 (g1, g2, miller, fp12) by n: {mxu_errs}")
        report["b7_mxu_errors"] = mxu_errs
        if any(any(e) for e in mxu_errs.values()):
            print("mxu_forms: an mxu build disagrees")
            return 1
        # times: B8 at both sizes, the Miller loop at the window's lanes
        timings = {}
        for n in B8_SIZES:
            a, b = _b8_operands(n, seed=n)

            def parent_b8(a=a, b=b):
                with parent(libs, "mont_mxu"):
                    fq8.mont7r_cuda(a, b)

            timings[f"b8_{n}"] = in_turns(lambda a=a, b=b: fq8.mont7r_cuda(a, b), parent_b8, reps=10)

        def parent_miller():
            with parent(libs, "pairing_mxu"):
                pairing.miller_loop_cuda(*wide)

        timings[f"miller_mxu_{n_max}"] = in_turns(lambda: pairing.miller_loop_cuda(*wide),
                                                  parent_miller, reps=3)
    finally:
        fq8.set_multiplier("u64")
    timings.update(probe_times(libs))
    for name, t in timings.items():
        print(f"{name}: " + ", ".join(f"{side} {v} ms" for side, v in t.items()))
    report["timings"] = timings
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
