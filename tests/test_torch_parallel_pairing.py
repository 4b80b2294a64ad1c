"""The port's sharded RLC batch (``parallel/pairing.py``) against the
reference's.

One subprocess on the reference's virtual 8-device JAX CPU mesh
(``conftest.run_in_cpu_mesh``) signs three sets and computes
``miller_partials_sharded`` at n in {1, 2} devices; the port runs its twin
on ``virtual_mesh(n, "cpu")`` (each shard through B7's plain versions) on
the same raw points and blinders. At two shards the three sets pad to four
lanes: a padded pk/H lane masked to one and a padded signature lane with
blinder 0. The Miller product (through ``convert.lv_to_ints``: the
reference's field is R' = 2^416, the port's R = 2^384) and the affine
signature sum must equal the reference's and the port's unsharded route's.
"""

import json

import numpy as np
import pytest
import torch

from conftest import run_in_cpu_mesh
from ethereum_consensus_tpu_torch import convert
from ethereum_consensus_tpu_torch.ops import fq
from ethereum_consensus_tpu_torch.ops import pairing as port_pairing
from ethereum_consensus_tpu_torch.parallel import pairing as port_pairing_mesh
from ethereum_consensus_tpu_torch.parallel import virtual_mesh
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

PAIRING_MESHES = (1, 2)
PAIRING_SETS = 3

REFERENCE = r"""
import json
import jax
import numpy as np
jax.config.update("jax_enable_x64", True)
from ethereum_consensus_tpu.crypto import bls
from ethereum_consensus_tpu.native import bls as native_bls
from ethereum_consensus_tpu.parallel import chip_mesh
from ethereum_consensus_tpu.parallel.pairing import miller_partials_sharded

out = {}
pk, h, sig, scalars = [], [], [], []
for i in range(PAIRING_SETS):
    sk = bls.SecretKey(i + 101)
    msg = b"m" * 31 + bytes([i])
    pk.append(sk.public_key().raw_uncompressed())
    rc, raw, _ = native_bls.g2_decompress(
        native_bls.hash_to_g2_compressed(msg, bls.ETH_DST), check_subgroup=False)
    assert rc == 0
    h.append(raw)
    sig.append(sk.sign(msg).raw_uncompressed())
    scalars.append(i * 7 + 3)
out["inputs"] = [[r.hex() for r in pk], [r.hex() for r in h], [r.hex() for r in sig], scalars]
for n_dev in PAIRING_MESHES:
    f_total, s_raw, s_inf = miller_partials_sharded(chip_mesh(n_dev), pk, h, sig, scalars)
    out[str(n_dev)] = [np.asarray(f_total).tolist(), s_raw.hex(), bool(s_inf)]
print("REFERENCE " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    code = f"PAIRING_MESHES = {PAIRING_MESHES!r}\nPAIRING_SETS = {PAIRING_SETS!r}\n" + REFERENCE
    out = run_in_cpu_mesh(code, n_devices=8)
    line = next(x for x in out.splitlines() if x.startswith("REFERENCE "))
    return json.loads(line[len("REFERENCE "):])


@pytest.fixture(scope="module")
def pairing_inputs(reference):
    pk, h, sig, scalars = reference["inputs"]
    return ([bytes.fromhex(r) for r in pk], [bytes.fromhex(r) for r in h],
            [bytes.fromhex(r) for r in sig], scalars)


@pytest.fixture(scope="module")
def unsharded(pairing_inputs):
    """The port's unsharded route: the Miller product and the affine
    signature sum of ``batch_verify_device``'s kernels."""
    pk, h, sig, scalars = pairing_inputs
    xp, yp = port_pairing.g1_mul_batched(port_pairing.g1_affine_from_raw(pk, "cpu"), scalars)
    fs = port_pairing.miller_loop_batched(xp, yp, *port_pairing.g2_affine_from_raw(h, "cpu"))
    sig_t = torch.stack(port_pairing.g2_affine_from_raw(sig, "cpu"), dim=1).contiguous()
    s_sum = port_pairing.g2_mul_sum(sig_t, port_pairing.scalar_words(scalars, "cpu"))
    return fq.to_ints(port_pairing.fp12_product(fs)), port_pairing._g2_point_to_raw(s_sum)


@pytest.mark.parametrize("n_dev", PAIRING_MESHES)
def test_miller_partials_sharded_match_reference(reference, pairing_inputs, unsharded, n_dev):
    f_total, s_raw, s_inf = port_pairing_mesh.miller_partials_sharded(
        virtual_mesh(n_dev, "cpu"), *pairing_inputs)
    ref_f, ref_s, ref_inf = reference[str(n_dev)]
    assert fq.to_ints(f_total) == convert.lv_to_ints(np.asarray(ref_f, dtype=np.uint64))
    assert (s_raw.hex(), s_inf) == (ref_s, ref_inf)
    assert (fq.to_ints(f_total), (s_raw, s_inf)) == unsharded


def test_blinder_zero_lane_is_the_identity(pairing_inputs):
    """A signature lane with blinder 0 (the padding) adds nothing to the G2
    sum: the blinded sum of one lane with a zero lane beside it is the
    lane's own."""
    _, _, sig, scalars = pairing_inputs
    pts = torch.stack(port_pairing.g2_affine_from_raw(sig[:2], "cpu"), dim=1).contiguous()
    with_zero = port_pairing.g2_mul_sum(pts, port_pairing.scalar_words([scalars[0], 0], "cpu"))
    alone = port_pairing.g2_mul_sum(pts[:1], port_pairing.scalar_words(scalars[:1], "cpu"))
    assert port_pairing._g2_point_to_raw(with_zero) == port_pairing._g2_point_to_raw(alone)
    zero = port_pairing.g2_mul_sum(pts[:1], port_pairing.scalar_words([0], "cpu"))
    assert not zero.any()


def test_batch_verify_sharded_rejects_swapped_signatures(pairing_inputs):
    """The accepting verdict is the window tests' (test_torch_mesh_runtime.py);
    here two signatures trade places."""
    pk, h, sig, scalars = pairing_inputs
    assert not port_pairing_mesh.batch_verify_sharded(pk, h, [sig[1], sig[0], sig[2]], scalars,
                                                      mesh=virtual_mesh(2, "cpu"))


def test_pad_width_matches_reference_rule():
    assert [port_pairing_mesh._pad_width(n, 2) for n in (1, 2, 3, 5)] == [1, 1, 2, 4]
    assert port_pairing_mesh._pad_width(528, 1) == 1024


def test_partials_reject_mismatched_inputs(pairing_inputs):
    pk, h, sig, scalars = pairing_inputs
    with pytest.raises(ValueError):
        port_pairing_mesh.miller_partials_sharded(virtual_mesh(1, "cpu"), pk, h[:2], sig, scalars)
    with pytest.raises(ValueError):
        port_pairing_mesh.miller_partials_sharded(virtual_mesh(1, "cpu"), [], [], [], [])
