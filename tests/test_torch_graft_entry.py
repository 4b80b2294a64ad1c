"""The port's graft entry (``graft_entry.py``) against the reference's
``__graft_entry__.py``.

``entry`` runs in-process in both packages (one device, no mesh): the same
seeded leaves, the same root words. ``dryrun_multichip(4, device="cpu")``
runs the port's five stages on four shards of the host at a small size,
each checked against the host inside the dryrun; its block stage takes a
signed altair block that the reference's chain helpers make on a
256-validator minimal genesis (16 aggregates over four slots and a full
sync aggregate), handed over as SSZ bytes. The reference's own dryrun (a
subprocess on a virtual JAX CPU mesh, about two minutes) does not run here.
"""

import numpy as np
import pytest

import __graft_entry__ as ref_graft
from chain_utils import make_attestation, produce_block_altair
from torch_genesis import fresh_genesis_altair
from ethereum_consensus_tpu.models.altair.slot_processing import process_slots
from ethereum_consensus_tpu.models.phase0 import helpers as ref_helpers
from ethereum_consensus_tpu_torch import graft_entry
from ethereum_consensus_tpu_torch.config import Context
from ethereum_consensus_tpu_torch.models.altair import build as port_altair
from ethereum_consensus_tpu_torch.parallel import runtime
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

BLOCK_VALIDATORS = 256


def test_entry_matches_reference():
    fn, args = graft_entry.entry(device="cpu")
    ref_fn, ref_args = ref_graft.entry()
    assert np.array_equal(args[0].numpy().view(np.uint32), np.asarray(ref_args[0]))
    assert np.array_equal(args[1].numpy().view(np.uint32), np.asarray(ref_args[1]))
    got = fn(*args).numpy().view(np.uint32)
    assert got.shape == (8,)
    assert np.array_equal(got, np.asarray(ref_fn(*ref_args)))


@pytest.fixture(scope="module")
def block_stage():
    """The reference's dryrun block at a small size: slot 4 on a fresh
    altair genesis, one aggregate per committee of slots 0..3 and a full
    sync aggregate; the port's pre-state, signed block and context."""
    state, ctx = fresh_genesis_altair(BLOCK_VALIDATORS, "minimal")
    target = state.slot + 4
    scratch = state.copy()
    process_slots(scratch, target, ctx)
    per_slot = ref_helpers.get_committee_count_per_slot(
        scratch, ref_helpers.get_current_epoch(scratch, ctx), ctx)
    atts = [make_attestation(scratch, slot, index, ctx)
            for slot in range(target - 4, target)
            if slot + ctx.MIN_ATTESTATION_INCLUSION_DELAY <= target
            for index in range(per_slot)]
    signed = produce_block_altair(state.copy(), target, ctx, attestations=atts)
    port_ctx = Context.for_minimal()
    ns = port_altair(port_ctx.preset)
    return (ns.BeaconState.deserialize(type(state).serialize(state)),
            ns.SignedBeaconBlock.deserialize(type(signed).serialize(signed)), port_ctx)


def test_dryrun_on_four_host_shards(block_stage, capsys):
    runtime.reset()
    summary = graft_entry.dryrun_multichip(4, device="cpu", block=block_stage,
                                           validators=(1 << 10) + 5)
    out = capsys.readouterr().out
    assert out.count("[dryrun]") == 10 and ": ok in " in out and "FAILED" not in out
    assert "dryrun_multichip ok: 4 shards of cpu" in out
    assert summary["padded"] == 4 * 128 * 4  # each shard an aligned 2^7-chunk subtree
    assert summary["epoch_sweep_total"] == ((1 << 10) + 5) * 32 * 10**9
    assert summary["attestations"] == 16 and summary["pairing_engaged"] >= 1
    assert len(summary["stages_s"]) == 5


def test_dryrun_without_a_block_raises():
    with pytest.raises(ValueError, match="block stage"):
        graft_entry.dryrun_multichip(4, device="cpu")
