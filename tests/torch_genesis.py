"""Genesis states for the port's tests, read back from their own bytes.

``chain_utils.fresh_genesis`` and ``fresh_genesis_fork`` hand out a
``copy()`` of one process-wide cached genesis. A copy shares the stored
group levels of the reference's incremental roots with the cached state,
and a test that settles a copy under a shrunk dirty-group geometry
(``tests/test_proofs.py``'s ``small_groups`` fixture sets
``ssz_core._DIRTY_GROUP_SHIFT`` to 2) leaves levels of that geometry behind
in the cache. After the geometry is restored, ``produce_chain`` on a later
copy writes wrong state roots into its blocks, and a block built there is
refused with ``InvalidStateRoot``. Which test file follows
``tests/test_proofs.py`` in a worker depends on ``--dist loadfile``.

The functions here return the same genesis deserialized from its
serialized bytes: a state with no stored levels, whatever ran before.
``clean_genesis()`` does the same for the chain functions of
``chain_utils`` that call ``fresh_genesis`` themselves.
"""

import contextlib

import chain_utils


def _read_back(state):
    typ = type(state)
    return typ.deserialize(typ.serialize(state))


def fresh_genesis(validator_count: int = 64, preset_name: str = "minimal"):
    state, ctx = chain_utils.cached_genesis(validator_count, preset_name)
    return _read_back(state), ctx


def fresh_genesis_fork(fork_name: str, validator_count: int = 64, preset_name: str = "minimal"):
    state, ctx = chain_utils.fresh_genesis_fork(fork_name, validator_count, preset_name)
    return _read_back(state), ctx


def fresh_genesis_altair(validator_count: int = 64, preset_name: str = "minimal"):
    return fresh_genesis_fork("altair", validator_count, preset_name)


def fresh_genesis_bellatrix(validator_count: int = 64, preset_name: str = "minimal"):
    return fresh_genesis_fork("bellatrix", validator_count, preset_name)


def fresh_genesis_capella(validator_count: int = 64, preset_name: str = "minimal"):
    return fresh_genesis_fork("capella", validator_count, preset_name)


def fresh_genesis_deneb(validator_count: int = 64, preset_name: str = "minimal"):
    return fresh_genesis_fork("deneb", validator_count, preset_name)


def fresh_genesis_electra(validator_count: int = 64, preset_name: str = "minimal"):
    return fresh_genesis_fork("electra", validator_count, preset_name)


@contextlib.contextmanager
def clean_genesis():
    """Route ``chain_utils.fresh_genesis`` through ``fresh_genesis`` above
    while the block runs, for ``produce_multi_fork_chain`` and
    ``produce_full_upgrade_chain`` (which builds on it when its disk cache
    misses)."""
    saved = chain_utils.fresh_genesis
    chain_utils.fresh_genesis = fresh_genesis
    try:
        yield
    finally:
        chain_utils.fresh_genesis = saved


def produce_multi_fork_chain(validator_count: int = 64):
    with clean_genesis():
        return chain_utils.produce_multi_fork_chain(validator_count)


def produce_full_upgrade_chain(validator_count: int = 64, **kwargs):
    with clean_genesis():
        return chain_utils.produce_full_upgrade_chain(validator_count, **kwargs)
