"""The phase0 block's cold device apply at 2^20 validators with telemetry off
and on, in turns, on one card: what recording costs the apply.

    python3 tools/telemetry_turns.py [--pairs N] [--on spans,device,memory] [--json PATH]
                                                                  # repo root, CUDA machine

Builds ``chip_smoke.py``'s registry state and its signed slot-2 block once.
Then, for each of N pairs, reads two states from the same SSZ bytes and
applies the block to each through ``Executor.apply_block`` after
``ops.install(device="cuda")``: one with spans recording and the device and
memory observatories on, one with them off, the recorded one first in
every other pair (off, on, on, off, ...); ``--on`` names which of the three
the recorded applies turn on (all by default). Every recorded apply's root
must equal the unrecorded one's and, with the device observatory on, its
launch ledger the launch counts. Prints each apply's wall and host
breakdown (``chip_smoke._apply``'s buckets), each side's median and their
difference beside the spread of each side; ``--json`` also writes them to
PATH.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def _one(registry: dict, signed_block, on: tuple) -> tuple:
    """One cold device apply on a state just read, with the observatories
    named in ``on`` (none: unrecorded): (seconds, host breakdown, root,
    ledger equal to the counts or None without the device observatory,
    spans)."""
    from ethereum_consensus_tpu_torch import convert, ops
    from ethereum_consensus_tpu_torch.telemetry import device, memory, spans

    data, ctx = registry["data"], registry["ctx"]
    with chip_smoke._collector_paused():
        if "memory" in on:
            memory.start()  # arms the census's list tracking before the read
        state = convert.state_from_ssz(data, ctx.preset)
        memory.stop()
    ops.uninstall()
    ops.install(device="cuda")
    chip_smoke._zero_launch_counts()
    if "spans" in on:
        spans.start_recording()
    if "device" in on:
        device.start()
    if "memory" in on:
        memory.start()
    try:
        seconds, parts = chip_smoke._apply(state, signed_block, ctx)
    finally:
        memory.stop()
        device.stop()
        spans.stop_recording()
    ops.uninstall()
    counts = {name: c for name, c in chip_smoke._launch_counts().items() if c}
    ledger_ok = device.OBSERVATORY.launches() == counts if "device" in on else None
    n_spans = len(spans.RECORDER.records()) if "spans" in on else 0
    return seconds, parts, type(state).hash_tree_root(state), ledger_ok, n_spans


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pairs", type=int, default=4)
    parser.add_argument("--on", default="spans,device,memory")
    parser.add_argument("--json", default=None)
    args = parser.parse_args()
    from ethereum_consensus_tpu_torch import _kernels, native
    from ethereum_consensus_tpu_torch.native import bls as native_bls

    chip_smoke.phase_device()  # the card's name and power limit; needs a card
    t0 = time.perf_counter()
    _kernels.build_all(["sha256", "shuffle", "g1_sum"])
    if not (native.available() and native_bls.available()):
        sys.exit("telemetry_turns: the native host libraries need g++")
    print(f"build {time.perf_counter() - t0:.1f} s")
    registry = chip_smoke.phase_registry(chip_smoke.VALIDATORS)
    with chip_smoke._collector_paused():
        block, _ = chip_smoke.make_block(chip_smoke._setup_state(registry), registry["ctx"],
                                         registry["committees"], registry["proposer"])
    on = tuple(args.on.split(","))
    if not on or not set(on) <= {"spans", "device", "memory"}:
        sys.exit(f"telemetry_turns: --on names spans, device or memory, got {args.on!r}")
    walls = {"off": [], "on": []}
    roots = set()
    for pair in range(args.pairs):
        for side in (("off", "on") if pair % 2 == 0 else ("on", "off")):
            seconds, parts, root, ledger_ok, n_spans = _one(
                registry, block, on if side == "on" else ())
            roots.add(root)
            walls[side].append(seconds)
            print(f"pair {pair} {side}: {seconds:.3f} s "
                  f"{ {k: round(v, 3) for k, v in parts.items()} }"
                  + (f", {n_spans} spans" if n_spans else "")
                  + (f", ledger equal to the counts {ledger_ok}" if ledger_ok is not None
                     else ""))
            if ledger_ok is False:
                sys.exit("telemetry_turns: the launch ledger is not the launch counts")
    if len(roots) != 1:
        sys.exit(f"telemetry_turns: the applies gave {len(roots)} roots")
    medians = {side: statistics.median(w) for side, w in walls.items()}
    spread = {side: max(w) - min(w) for side, w in walls.items()}
    print(f"medians off {medians['off']:.3f} s, on {medians['on']:.3f} s "
          f"({100 * (medians['on'] / medians['off'] - 1):+.1f}%); spread (max - min) "
          f"off {spread['off']:.3f} s, on {spread['on']:.3f} s; root {roots.pop().hex()}")
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump({"walls": walls, "medians": medians, "spread": spread}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
