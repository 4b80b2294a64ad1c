"""The read plane's test chain: the reference's five-boundary upgrade chain
(``chain_utils.produce_full_upgrade_chain(64)``: phase0, then altair to
electra one epoch each) applied by the reference ``Executor``, as SSZ bytes,
and ``HeadStore``s of both packages fed the same commits.

``chain()`` is built once a process. ``stores(package, upto)`` publishes
genesis and every committed state up to block index ``upto`` (inclusive)
into a fresh store of that package, each snapshot with its signed block,
its state root and its block root, as the pipeline publishes them.
"""

import functools

import chain_utils
import torch_genesis
from ethereum_consensus_tpu import executor as ref_executor
from ethereum_consensus_tpu import serving as ref_serving
from ethereum_consensus_tpu.fork import Fork as RefFork
from ethereum_consensus_tpu.types import fork_module as ref_fork_module
from ethereum_consensus_tpu_torch import serving as port_serving
from ethereum_consensus_tpu_torch.config import Context
from ethereum_consensus_tpu_torch.fork import Fork
from ethereum_consensus_tpu_torch.types import fork_module

FORKS = chain_utils.FULL_UPGRADE_FORKS


class Commit:
    """One committed position: the fork, the state's bytes and root, the
    signed block's bytes (None for genesis) and the block root."""

    __slots__ = ("fork", "state", "root", "block", "block_root", "slot")

    def __init__(self, fork, state, root, block, block_root, slot):
        self.fork, self.state, self.root = fork, state, root
        self.block, self.block_root, self.slot = block, block_root, slot


@functools.lru_cache(maxsize=1)
def chain() -> tuple:
    """(commits, reference context): genesis, then one commit a block."""
    state, ctx, blocks = torch_genesis.produce_full_upgrade_chain(64)
    genesis = Commit("phase0", type(state).serialize(state), type(state).hash_tree_root(state),
                     None, None, 0)
    ex = ref_executor.Executor(state.copy(), ctx)
    commits = [genesis]
    for block in blocks:
        ex.apply_block(block)
        raw = ex.state.data
        commits.append(Commit(
            str(ex.state.version()), type(raw).serialize(raw), type(raw).hash_tree_root(raw),
            type(block).serialize(block), type(block.message).hash_tree_root(block.message),
            int(block.message.slot)))
    return commits, ctx


def last_of(fork: str) -> int:
    """The index in ``chain()[0]`` of the fork's last commit."""
    commits, _ = chain()
    return max(i for i, c in enumerate(commits) if c.fork == fork)


def port_context() -> Context:
    """A port context with the chain's fork schedule."""
    _, ref_ctx = chain()
    ctx = Context.for_minimal()
    for fork in FORKS[1:]:
        name = f"{fork}_fork_epoch"
        setattr(ctx, name, getattr(ref_ctx, name))
    return ctx


def port_type(fork: str, name: str):
    return getattr(fork_module(Fork.from_str(fork)).build(Context.for_minimal().preset), name)


def ref_type(fork: str, name: str):
    _, ref_ctx = chain()
    return getattr(ref_fork_module(RefFork.from_str(fork)).build(ref_ctx.preset), name)


def read(package: str, commit: Commit) -> tuple:
    """(state, signed block or None) of ``commit`` in ``package``'s types."""
    typ = port_type if package == "port" else ref_type
    state = typ(commit.fork, "BeaconState").deserialize(commit.state)
    block = None
    if commit.block is not None:
        block = typ(commit.fork, "SignedBeaconBlock").deserialize(commit.block)
    return state, block


def stores(package: str, upto: int, start: int = 0):
    """A fresh ``HeadStore`` of ``package`` ("port" or "ref") holding the
    commits ``start..upto`` of the chain, oldest first."""
    commits, ref_ctx = chain()
    ctx = port_context() if package == "port" else ref_ctx
    store = (port_serving if package == "port" else ref_serving).HeadStore()
    for commit in commits[start:upto + 1]:
        state, block = read(package, commit)
        store.publish(state, ctx, slot=commit.slot, root=commit.root,
                      block_root=commit.block_root, block=block)
    return store
