"""Both packages' write planes on one head, for the pool's parity tests.

``chain(fork)`` builds a short minimal chain with the reference's
``chain_utils`` on a genesis read back from its bytes
(``tests/torch_genesis.py``), applies it with the reference ``Executor``
and keeps the head state's bytes. ``sides(fork)`` reads those bytes into a
fresh ``HeadStore`` of each package: a ``Side`` holds one package's pool
package, metrics registry, context, store and fork namespace, so a test
feeds the same serialized messages to the reference's engines and the
port's and compares what comes out.
"""

import functools
import json

import chain_utils as cu
import torch_genesis
from ethereum_consensus_tpu import executor as ref_executor
from ethereum_consensus_tpu import pool as ref_pool
from ethereum_consensus_tpu import serving as ref_serving
from ethereum_consensus_tpu.fork import Fork as RefFork
from ethereum_consensus_tpu.telemetry import metrics as ref_metrics
from ethereum_consensus_tpu.telemetry import server as ref_server
from ethereum_consensus_tpu.types import fork_module as ref_fork_module
from ethereum_consensus_tpu_torch import executor as port_executor
from ethereum_consensus_tpu_torch import pool as port_pool
from ethereum_consensus_tpu_torch import serving as port_serving
from ethereum_consensus_tpu_torch.config import Context
from ethereum_consensus_tpu_torch.crypto import bls as port_bls
from ethereum_consensus_tpu_torch.domains import DomainType
from ethereum_consensus_tpu_torch.fork import Fork
from ethereum_consensus_tpu_torch.models.phase0 import helpers as port_h
from ethereum_consensus_tpu_torch.signing import compute_signing_root
from ethereum_consensus_tpu_torch.ssz import uint64
from ethereum_consensus_tpu_torch.telemetry import metrics as port_metrics
from ethereum_consensus_tpu_torch.telemetry import server as port_server
from ethereum_consensus_tpu_torch.types import fork_module

REJECTED = tuple(f"pool.rejected.{reason}" for reason in ref_pool.REASONS)


def port_context(ref_ctx) -> Context:
    """A port context with the reference context's fork schedule and
    shard committee period."""
    ctx = Context.for_minimal()
    for fork in cu.FULL_UPGRADE_FORKS[1:]:
        name = f"{fork}_fork_epoch"
        setattr(ctx, name, getattr(ref_ctx, name))
    ctx.shard_committee_period = ref_ctx.shard_committee_period
    return ctx


@functools.lru_cache(maxsize=None)
def chain(fork: str, n_blocks: int = 3, atts_per_block: int = 1) -> tuple:
    """(reference context, signed blocks, the head state's bytes)."""
    state, ctx = torch_genesis.fresh_genesis_fork(fork, 64)
    blocks = cu.produce_chain(state, ctx, n_blocks, fork_name=fork,
                              atts_per_block=atts_per_block)
    ex = ref_executor.Executor(state.copy(), ctx)
    for block in blocks:
        ex.apply_block(block)
    raw = ex.state.data
    return ctx, blocks, type(raw).serialize(raw)


class Side:
    """One package's write plane on the head: ``pool`` (the package),
    ``metrics``, ``ctx``, ``store``, ``ns`` (the head fork's containers),
    ``executor`` (the head, wrapped) and the HTTP ``server`` module."""

    def __init__(self, name, fork, pool, metrics, ctx, ns, executor_mod, serving, server):
        self.name, self.fork, self.pool, self.metrics = name, fork, pool, metrics
        self.ctx, self.ns, self.serving, self.server = ctx, ns, serving, server
        self.executor_mod = executor_mod
        self.executor = None
        self.store = None

    def head(self, data: bytes) -> "Side":
        state = self.ns.BeaconState.deserialize(data)
        self.executor = self.executor_mod.Executor(state, self.ctx)
        self.store = self.serving.HeadStore()
        self.store.publish(self.executor.state, self.ctx)
        return self

    def load(self, type_name: str, data: bytes):
        return getattr(self.ns, type_name).deserialize(data)

    def engine(self, rlc: bool, window: int = 64):
        return self.pool.AdmissionEngine(self.pool.OperationPool(), self.store, self.ctx,
                                         window_size=window, rlc=rlc)

    def counters(self, names=REJECTED) -> dict:
        return {n: self.metrics.counter(n).value() for n in names}


def sides(fork: str, **chain_kwargs) -> tuple:
    """(reference side, port side) on fresh stores of ``chain(fork)``'s head."""
    ref_ctx, _blocks, data = chain(fork, **chain_kwargs)
    ref_ns = ref_fork_module(RefFork.from_str(fork)).build(ref_ctx.preset)
    ctx = port_context(ref_ctx)
    port_ns = fork_module(Fork.from_str(fork)).build(ctx.preset)
    ref = Side("ref", fork, ref_pool, ref_metrics, ref_ctx, ref_ns, ref_executor, ref_serving,
               ref_server).head(data)
    port = Side("port", fork, port_pool, port_metrics, ctx, port_ns, port_executor,
                port_serving, port_server).head(data)
    return ref, port


def view_doc(pool) -> str:
    return json.dumps([type(a).to_json(a) for a in pool.attestations_view()], sort_keys=True)


def ser(container) -> bytes:
    return type(container).serialize(container)


def admit(side: Side, kind: str, messages: list, rlc: bool, window: int = 64,
          engine=None) -> tuple:
    """Feed the serialized ``messages`` of ``kind`` ("attestation" or an op
    kind) to a new engine of ``side`` (or ``engine``), one at a time, then
    settle. Returns (engine, [(status, reason)], the rejection counters'
    deltas)."""
    engine = engine or side.engine(rlc, window)
    type_name, admit_fn = {
        "attestation": ("Attestation", engine.admit_attestation),
        "voluntary_exit": ("SignedVoluntaryExit", engine.admit_voluntary_exit),
        "proposer_slashing": ("ProposerSlashing", engine.admit_proposer_slashing),
        "attester_slashing": ("AttesterSlashing", engine.admit_attester_slashing),
        "bls_change": ("SignedBlsToExecutionChange", engine.admit_bls_change),
    }[kind]
    before = side.counters()
    tickets = [admit_fn(side.load(type_name, m)) for m in messages]
    engine.settle()
    after = side.counters()
    deltas = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    return engine, [(t.status, t.reason) for t in tickets], deltas


# -- the port's key callbacks for produce_block (the reference's are
# chain_utils.make_randao_reveal and sign_block) -----------------------------


def port_randao(state, slot: int, context) -> bytes:
    epoch = slot // context.SLOTS_PER_EPOCH
    key = port_bls.SecretKey(port_h.get_beacon_proposer_index(state, context) + 1)
    domain = port_h.get_domain(state, DomainType.RANDAO, epoch, context)
    return key.sign(compute_signing_root(uint64, epoch, domain)).to_bytes()


def port_sign(state, block, context) -> bytes:
    domain = port_h.get_domain(state, DomainType.BEACON_PROPOSER, None, context)
    key = port_bls.SecretKey(int(block.proposer_index) + 1)
    return key.sign(compute_signing_root(type(block), block, domain)).to_bytes()
