"""``python -m ethereum_consensus_tpu_torch.pipeline --selfcheck`` — smoke
the pipeline end-to-end without pytest.

It runs on the card: ``ops.install(device="cuda")`` routes the spec
path's device work first (the default thresholds). ``--device cpu``
installs the kernels' plain versions on the CPU instead.

Two tiers, both always run:

* **chain tier** — build a minimal-preset phase0 chain with the port
  alone (64 genesis deposits signed with ``SecretKey(i + 1)``, six
  blocks, each with the previous slot's first committee's aggregate),
  replay it pipelined vs sequential, require bit-identical roots; then
  tamper a mid-stream block signature and require rollback to the last
  committed state with the structured error.
* **window tier** — drive the scheduler + signature-window machinery
  directly with real BLS keys, including a tampered-set
  rollback-attribution check.

Telemetry exports:

* ``--lanes N``          — run the chain tier with N verifier lanes
  (``FlushPolicy.verify_lanes``): windows fan over N FIFO workers,
  settle order preserved.
* ``--trace-out PATH``   — record every span/event of the selfcheck and
  write a Chrome trace-event JSON (Perfetto / ``chrome://tracing``):
  stage A and the background verifier render as separate tracks with
  flush dispatch/verify/settle windows and rollbacks visible.
* ``--metrics-out PATH`` — dump the process-wide metrics registry
  snapshot as JSON.
* ``--memory-out PATH``  — run the memory & bandwidth observatory for
  the selfcheck and write its ledgers as JSON.
* ``--device-out PATH``  — run the device execution observatory
  (``telemetry/device.py``) for the selfcheck's duration and dump its
  ledgers (kernel-library loads, launches, transfers, the routing
  journal) as JSON.

* ``--serve PORT``       — run the live introspection server
  (``telemetry/server.py``: /metrics, /healthz, /blocks, /events, ...)
  for the selfcheck's duration; 0 picks an ephemeral port. ``--hold
  SECONDS`` keeps it up after the checks finish.
* ``--serve-data``       — additionally mount the Beacon-API read data
  plane (``serving/``: validators, balances, committees, duties, proofs,
  light-client documents) fed by the chain tier's commits; requires
  ``--serve``.

Exit code 0 = all checks passed; any failure prints the reason and
exits 1.

Reference parity: ethereum_consensus_tpu/pipeline/__main__.py, whose
chain tier builds its chain with the reference's test helpers.
"""

from __future__ import annotations

import sys

ETH1_BLOCK_HASH = b"\x42" * 32
ETH1_TIMESTAMP = 1578009600
GENESIS_VALIDATORS = 64
CHAIN_BLOCKS = 6


def _secret_key(index: int):
    from ..crypto import bls

    return bls.SecretKey(index + 1)


def genesis_state(validators: int, ctx):
    """A phase0 genesis state of ``validators`` full deposits, validator i's
    key ``SecretKey(i + 1)`` (each deposit proven against the incremental
    deposit tree, as the deposit contract builds it)."""
    from ..crypto import bls
    from ..domains import DomainType
    from ..models.phase0 import build, genesis
    from ..models.phase0 import helpers as h
    from ..models.phase0.containers import (
        DEPOSIT_CONTRACT_TREE_DEPTH,
        DepositData,
        DepositMessage,
    )
    from ..signing import compute_signing_root
    from ..ssz.hash import hash_pair
    from ..ssz.merkle import zero_hash

    ns = build(ctx.preset)
    domain = h.compute_domain(DomainType.DEPOSIT, None, None, ctx)
    branch: list = [None] * DEPOSIT_CONTRACT_TREE_DEPTH
    deposits = []
    for i in range(validators):
        sk = _secret_key(i)
        public_key = sk.public_key().to_bytes()
        message = DepositMessage(
            public_key=public_key,
            withdrawal_credentials=b"\x00" + bls.hash(public_key)[1:],
            amount=ctx.MAX_EFFECTIVE_BALANCE,
        )
        data = DepositData(
            public_key=message.public_key,
            withdrawal_credentials=message.withdrawal_credentials,
            amount=message.amount,
            signature=sk.sign(
                compute_signing_root(DepositMessage, message, domain)
            ).to_bytes(),
        )
        proof = [
            branch[d] if (i >> d) & 1 else zero_hash(d)
            for d in range(DEPOSIT_CONTRACT_TREE_DEPTH)
        ]
        proof.append((i + 1).to_bytes(32, "little"))
        deposits.append(ns.Deposit(proof=proof, data=data))
        node, size, d = DepositData.hash_tree_root(data), i + 1, 0
        while size % 2 == 0:
            node = hash_pair(branch[d], node)
            size //= 2
            d += 1
        branch[d] = node
    return genesis.initialize_beacon_state_from_eth1(
        ETH1_BLOCK_HASH, ETH1_TIMESTAMP, deposits, ctx
    )


def _attestation(state, slot: int, ctx):
    """Slot ``slot``'s first committee's full aggregate (``state`` at a
    later slot of the same epoch)."""
    from ..crypto import bls
    from ..domains import DomainType
    from ..models.phase0 import build
    from ..models.phase0 import helpers as h
    from ..signing import compute_signing_root

    ns = build(ctx.preset)
    committee = h.get_beacon_committee(state, slot, 0, ctx)
    epoch = slot // ctx.SLOTS_PER_EPOCH
    data = ns.AttestationData(
        slot=slot,
        index=0,
        beacon_block_root=h.get_block_root_at_slot(state, slot),
        source=state.current_justified_checkpoint.copy(),
        target=ns.Checkpoint(
            epoch=epoch,
            root=h.get_block_root_at_slot(
                state, h.compute_start_slot_at_epoch(epoch, ctx)
            ),
        ),
    )
    root = compute_signing_root(
        ns.AttestationData, data,
        h.get_domain(state, DomainType.BEACON_ATTESTER, epoch, ctx),
    )
    signature = bls.aggregate([_secret_key(i).sign(root) for i in committee])
    return ns.Attestation(
        aggregation_bits=[True] * len(committee), data=data,
        signature=signature.to_bytes(),
    )


def produce_chain(state, ctx, n_blocks: int) -> list:
    """``n_blocks`` signed phase0 blocks at slots 1.. on a copy of
    ``state``; block k > 1 carries slot k - 1's first committee's
    aggregate. ``state`` itself is left as it is."""
    from ..domains import DomainType
    from ..models.phase0 import block_processing, build
    from ..models.phase0 import helpers as h
    from ..models.phase0 import slot_processing
    from ..models.phase0.containers import BeaconBlockHeader
    from ..signing import compute_signing_root
    from ..ssz import uint64

    ns = build(ctx.preset)
    scratch = state.copy()
    blocks = []
    for slot in range(1, n_blocks + 1):
        slot_processing.process_slots(scratch, slot, ctx)
        attestations = [_attestation(scratch, slot - 1, ctx)] if slot > 1 else []
        proposer = h.get_beacon_proposer_index(scratch, ctx)
        epoch = slot // ctx.SLOTS_PER_EPOCH
        randao = _secret_key(proposer).sign(compute_signing_root(
            uint64, epoch, h.get_domain(scratch, DomainType.RANDAO, epoch, ctx)))
        block = ns.BeaconBlock(
            slot=slot,
            proposer_index=proposer,
            parent_root=BeaconBlockHeader.hash_tree_root(
                scratch.latest_block_header
            ),
            body=ns.BeaconBlockBody(
                randao_reveal=randao.to_bytes(),
                eth1_data=scratch.eth1_data.copy(),
                attestations=attestations,
            ),
        )
        block_processing.process_block(scratch, block, ctx)
        block.state_root = type(scratch).hash_tree_root(scratch)
        root = compute_signing_root(
            ns.BeaconBlock, block,
            h.get_domain(scratch, DomainType.BEACON_PROPOSER, None, ctx),
        )
        blocks.append(ns.SignedBeaconBlock(
            message=block, signature=_secret_key(proposer).sign(root).to_bytes()
        ))
    return blocks


def _selfcheck_chain(lanes: int = 1) -> None:
    from ..config import Context
    from ..error import InvalidBlock
    from ..executor import Executor
    from . import ChainPipeline, FlushPolicy

    ctx = Context.for_minimal()
    state = genesis_state(GENESIS_VALIDATORS, ctx)
    blocks = produce_chain(state, ctx, CHAIN_BLOCKS)

    # pipelined replay must be bit-identical to sequential
    sequential = Executor(state.copy(), ctx)
    for block in blocks:
        sequential.apply_block(block)
    pipelined = Executor(state.copy(), ctx)
    stats = pipelined.stream(
        blocks,
        policy=FlushPolicy(
            window_size=3,
            max_in_flight=max(2, lanes),
            verify_lanes=lanes,
        ),
    )
    if pipelined.state.hash_tree_root() != sequential.state.hash_tree_root():
        raise AssertionError("pipelined root != sequential root")
    if lanes > 1:
        print(f"chain tier: {lanes} verifier lanes, settle order preserved")
    if stats.blocks_committed != CHAIN_BLOCKS:
        raise AssertionError(f"committed {stats.blocks_committed}/{CHAIN_BLOCKS}")
    print(
        f"chain tier: {CHAIN_BLOCKS} blocks bit-identical; "
        f"flushes={stats.flushes} occ={stats.occupancy()}"
    )

    # mid-stream invalid proposer signature (a VALID G2 point signing the
    # wrong message, so it survives parsing and fails only at the pairing):
    # rollback + structured error
    bad = blocks[3].copy()
    bad.signature = bytes(blocks[2].signature)
    broken = Executor(state.copy(), ctx)
    pipe = ChainPipeline(broken, policy=FlushPolicy(window_size=2))
    caught = None
    try:
        for block in blocks[:3] + [bad] + blocks[4:]:
            pipe.submit(block)
        pipe.close()
    except Exception as exc:  # noqa: BLE001 — selfcheck inspects it
        caught = exc
    if not isinstance(caught, InvalidBlock):
        raise AssertionError(f"expected InvalidBlock, got {caught!r}")
    expect = Executor(state.copy(), ctx)
    for block in blocks[:3]:
        expect.apply_block(block)
    if broken.state.hash_tree_root() != expect.state.hash_tree_root():
        raise AssertionError("rollback state != last committed prefix")
    print("chain tier: mid-stream rollback + structured error OK")


def _selfcheck_window() -> None:
    from ..crypto import bls
    from ..error import InvalidAttestation
    from ..models.signature_batch import SignatureBatch
    from .scheduler import FlushPolicy, VerifyScheduler, Window
    from .stats import PipelineStats

    sks = [bls.SecretKey(i + 101) for i in range(6)]
    stats = PipelineStats()
    stats.start()
    sched = VerifyScheduler(FlushPolicy(window_size=3, max_in_flight=2), stats)

    def make_batch(tamper: bool) -> SignatureBatch:
        batch = SignatureBatch()
        for i, sk in enumerate(sks):
            msg = b"selfcheck-%d" % i
            sig = sk.sign(msg if not tamper or i != 3 else b"wrong")
            batch.defer(
                [sk.public_key()], msg, sig, InvalidAttestation(f"set {i}")
            )
        return batch

    good, bad = make_batch(False), make_batch(True)
    sched.dispatch(Window([None], good, None, 0))
    sched.dispatch(Window([None], bad, None, 1))
    if not sched.full:
        raise AssertionError("bounded queue did not fill at cap")
    _, verdicts = sched.settle_oldest()
    if not all(verdicts):
        raise AssertionError("valid window rejected")
    _, verdicts = sched.settle_oldest()
    if verdicts.index(False) != 3:
        raise AssertionError(f"bad set misattributed: {verdicts}")
    stats.stop()
    print(
        f"window tier: coalesced verify + attribution OK "
        f"(high_watermark={stats.queue_high_watermark})"
    )


def _flag_value(argv: "list[str]", flag: str) -> "str | None":
    if flag in argv:
        at = argv.index(flag)
        if at + 1 >= len(argv):
            raise SystemExit(f"{flag} requires an argument")
        return argv[at + 1]
    return None


def _dump(path: str, value) -> None:
    import json

    with open(path, "w", encoding="utf-8") as f:
        json.dump(value, f, indent=1, sort_keys=True)


def main(argv: "list[str]") -> int:
    if "--selfcheck" not in argv:
        print(__doc__)
        return 2
    trace_out = _flag_value(argv, "--trace-out")
    metrics_out = _flag_value(argv, "--metrics-out")
    device_out = _flag_value(argv, "--device-out")
    memory_out = _flag_value(argv, "--memory-out")
    serve_port = _flag_value(argv, "--serve")
    hold_s = _flag_value(argv, "--hold")
    lanes = int(_flag_value(argv, "--lanes") or "1")
    device = _flag_value(argv, "--device") or "cuda"
    if serve_port is None and "--serve-data" in argv:
        raise SystemExit("--serve-data requires --serve PORT")
    from .. import ops
    from ..telemetry import device as device_obs
    from ..telemetry import memory as memory_obs
    from ..telemetry import metrics, spans

    # the install first: a machine that cannot run it fails before anything
    # is started
    ops.install(device=device)
    print(f"selfcheck on {device!r} (ops.install at the default thresholds)")
    server = None
    store = None
    if serve_port is not None:
        from ..telemetry.server import IntrospectionServer

        server = IntrospectionServer(port=int(serve_port)).start()
        print(f"introspection server on {server.url()} (/metrics /healthz /blocks /events)")
        if "--serve-data" in argv:
            from ..serving import BeaconDataPlane, HeadStore

            store = HeadStore().attach()
            server.mount(BeaconDataPlane(store))
            print(f"beacon data plane mounted on {server.url('/eth/')} (validators, balances, "
                  "committees, duties, proofs — fed by the chain tier's commits)")
    if trace_out:
        spans.start_recording()
    if device_out:
        device_obs.start()
    if memory_out:
        memory_obs.start()
    try:
        _selfcheck_chain(lanes=lanes)
        _selfcheck_window()
    except Exception as exc:  # noqa: BLE001 — smoke must report, not crash
        print(f"SELFCHECK FAILED: {type(exc).__name__}: {exc}")
        if store is not None:
            store.detach()
        if server is not None:
            server.stop()
        return 1
    finally:
        ops.uninstall()
        if trace_out:
            spans.stop_recording()
            spans.write_chrome_trace(trace_out)
            print(f"chrome trace written: {trace_out}")
        if metrics_out:
            _dump(metrics_out, metrics.snapshot())
            print(f"metrics snapshot written: {metrics_out}")
        if device_out:
            device_obs.stop()
            _dump(device_out, device_obs.snapshot())
            print(f"device ledger written: {device_out}")
        if memory_out:
            memory_obs.stop()
            _dump(memory_out, memory_obs.snapshot())
            print(f"memory ledger written: {memory_out}")
    print("selfcheck OK")
    if server is not None:
        if hold_s is not None and float(hold_s) > 0:
            import time

            print(f"holding the introspection server for {hold_s}s "
                  f"({server.url('/blocks')} has the selfcheck's lineage)")
            if store is not None and store.head is not None:
                print(f"data plane head: slot {store.head.slot} — try "
                      f"{server.url('/eth/v1/beacon/states/head/validators?id=0,1,2')}")
            time.sleep(float(hold_s))
        if store is not None:
            store.detach()
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
