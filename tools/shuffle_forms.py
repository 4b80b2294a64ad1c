"""B4 (the committee shuffle, csrc/shuffle.cu) beside the whole-list form
(tools/shuffle_whole_list.cu: one coalesced pass a round over an int32
list, 90 launches), on one card and the same seeded tables: both checked
against the plain version, both timed with chip_smoke's CUDA-event timer
in turns (B4, whole list, whole list, B4) at 2^15, 2^20 and 2^21 + 5.

    python3 tools/shuffle_forms.py      # from the repository root, on a CUDA machine

The whole-list form is a measured comparison, not part of the program.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from ethereum_consensus_tpu_torch import _kernels  # noqa: E402
from ethereum_consensus_tpu_torch.ops import shuffle  # noqa: E402

COUNTS = (1 << 15, 1 << 20, (1 << 21) + 5)
ROUNDS = 90


def build() -> ctypes.CDLL:
    os.makedirs(_kernels._BUILD, exist_ok=True)
    lib_path = os.path.join(_kernels._BUILD, "whole_list.so")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "shuffle_whole_list.cu")
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", lib_path, src], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.whole_list_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_void_p]
    lib.whole_list_launch.restype = ctypes.c_int
    return lib


def main() -> int:
    chip_smoke.phase_device()
    lib = build()
    for count in COUNTS:
        pivots, sources = (torch.from_numpy(t).cuda()
                           for t in shuffle.shuffle_sources(count, bytes(range(32)), ROUNDS))
        plain = shuffle.shuffle_plain(pivots, sources, count)
        scratch = torch.empty(2 * count, dtype=torch.int32, device="cuda")
        out = torch.empty(count, dtype=torch.int64, device="cuda")

        def whole_list():
            rc = lib.whole_list_launch(pivots.data_ptr(), sources.data_ptr(), sources.shape[1],
                                       ROUNDS, count, scratch.data_ptr(), out.data_ptr(),
                                       torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"whole-list launch failed: CUDA error {rc}")

        def b4():
            return shuffle._launch(pivots, sources, count)

        whole_list()
        errs = {"B4": chip_smoke._max_err(b4(), plain),
                "whole list": chip_smoke._max_err(out, plain)}
        times = {"B4": [], "whole list": []}
        for name in ("B4", "whole list", "whole list", "B4"):
            times[name].append(chip_smoke._cuda_ms(b4 if name == "B4" else whole_list, reps=20))
        bound, bound_by = chip_smoke.shuffle_bound_ms(count, ROUNDS)
        print(f"count {count}: max_abs_err vs plain {errs}; ms {times} "
              f"(bound {bound:.4f} ms by {bound_by})")
        if any(errs.values()):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
