"""The port's batched pairing (ops/fq.py, fq2.py, fq12.py, pairing.py and
csrc/fp_tower.h) against the reference package.

Every comparison is of exact canonical integers; the reference's lazy
columns come across through ``convert.lv_to_ints``. The inputs are four
signed sets made from a numpy seed. The reference's device programs run
on JAX's CPU at four lanes (its Miller loop also at one, for the extra
pair), compiled once in module-scoped fixtures:

  - the tower (Fq2 and Fq12 products, squares, the sparse line product,
    the inverse) against the reference's ops/fq2.py and ops/fq12.py;
  - one ``batch_verify_device`` through the plain versions, each kernel's
    output recorded: the G1 blinder multiplication (affine), the G2 sum
    (Jacobian, limb for limb), the one Miller call's n + 1 lanes (the
    sets' Miller values, then the extra pair at lane n) and their product
    against the reference's functions (the product against the reference's
    product times its extra pair), the Miller values also against the
    native miller_loop_raw, and the verdict against the reference's; the G2
    multiplication of a lane limb for limb and ``g2_sum_points`` on the
    reference's lanes; a batch whose signature sum is infinity runs no
    extra lane and gives the reference's verdict;
  - ``fp_tower.h`` built with g++ and held against Python integers, the
    native Miller loop and the plain versions;
  - under the "mxu" multiplier (``fq8.set_multiplier``: every product of
    the plain versions is ``fq8.mont7r``'s), the same batch's stages
    identical to the u64 ones, a tampered batch's verdict against the
    native one, the plain B6 set sums identical to the u64 ones, and the
    dispatchers and launchers as under u64.

The kernels themselves run only where a CUDA card is present.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ethereum_consensus_tpu.crypto import bls as ref_bls  # noqa: E402
from ethereum_consensus_tpu.crypto.fields import Fq, Fq2, Fq6, Fq12  # noqa: E402
from ethereum_consensus_tpu.crypto.hash_to_curve import ETH_DST  # noqa: E402
from ethereum_consensus_tpu.native import bls as ref_native  # noqa: E402
from ethereum_consensus_tpu.ops import fq2 as ref_fq2  # noqa: E402
from ethereum_consensus_tpu.ops import fq12 as ref_fq12  # noqa: E402
from ethereum_consensus_tpu.ops import fql as ref_fql  # noqa: E402
from ethereum_consensus_tpu.ops import pairing as ref_pairing  # noqa: E402
from ethereum_consensus_tpu_torch import _device_flags, _env, convert, ops  # noqa: E402
from ethereum_consensus_tpu_torch.ops import fq, fq2, fq8, fq12, g1, pairing  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse fixture)

CSRC = Path(pairing.__file__).resolve().parents[1] / "csrc"
P = fq.P_INT
LANES = 4


def _rand_fq(rng) -> int:
    return int.from_bytes(rng.bytes(48), "big") % P


def _fq12(values) -> Fq12:
    f2 = [Fq2(Fq(values[2 * i]), Fq(values[2 * i + 1])) for i in range(6)]
    return Fq12(Fq6(*f2[:3]), Fq6(*f2[3:]))


def _fq12_ints(value: Fq12) -> list:
    return [c for c6 in (value.c0, value.c1) for c2 in (c6.c0, c6.c1, c6.c2)
            for c in (c2.c0.n, c2.c1.n)]


def _raw576_ints(raw: bytes) -> list:
    return [int.from_bytes(raw[48 * i : 48 * (i + 1)], "big") for i in range(12)]


@pytest.fixture(scope="module")
def batch():
    """Four signed single-key sets and their blinders, from a seed: the
    first blinder is 1, as verify_signature_sets draws it, one has its top
    bit set."""
    rng = np.random.default_rng(5)
    out = {"pk": [], "h": [], "sig": [], "msg": [], "sig96": []}
    for _ in range(LANES):
        sk = ref_bls.SecretKey(int.from_bytes(rng.bytes(31), "big") + 1)
        msg = rng.bytes(32)
        out["msg"].append(msg)
        out["sig96"].append(sk.sign(msg).to_bytes())
        out["pk"].append(sk.public_key().raw_uncompressed())
        out["sig"].append(ref_native.g2_decompress(out["sig96"][-1], True)[1])
        out["h"].append(ref_native.g2_decompress(
            ref_native.hash_to_g2_compressed(msg, ETH_DST), False)[1])
    out["scalars"] = [1, (1 << 127) | int.from_bytes(rng.bytes(15), "big")] + [
        int.from_bytes(rng.bytes(16), "big") | 1 for _ in range(LANES - 2)]
    return out


@pytest.fixture(scope="module")
def reference(batch):
    """The reference's stages on JAX's CPU, as canonical integers."""
    pk_jac = ref_pairing._g1_jac_from_affine_raws(batch["pk"])
    blinded = ref_pairing.g1_mul_batched(pk_jac, batch["scalars"])
    xp, yp = ref_pairing._g1_jacobian_to_affine(blinded.arr)
    sx, sy = ref_pairing.g2_affine_from_raw(batch["sig"])
    one2 = jnp.broadcast_to(
        jnp.asarray(np.stack([ref_fql.to_mont_cols(1), np.zeros(24, np.uint64)])), sy.arr.shape)
    sig_jac = ref_pairing._env(jnp.stack([sx.arr, sy.arr, one2], axis=-3))
    sig_lanes = ref_pairing.g2_mul_batched(sig_jac, batch["scalars"])
    xq, yq = ref_pairing.g2_affine_from_raw(batch["h"])
    fs = ref_pairing.miller_loop_batched(xp, yp, xq.arr, yq.arr)
    sig_sum = ref_pairing.g2_sum_points(sig_lanes)
    # the extra pair e(-G, S), as the reference's finalize_verdict takes it
    s_raw, _ = ref_pairing._g2_point_to_raw(sig_sum)
    extra = ref_pairing.miller_loop_batched(
        *(v.arr for v in ref_pairing.g1_affine_from_raw([ref_pairing._neg_g1_generator_raw()])),
        *(v.arr for v in ref_pairing.g2_affine_from_raw([s_raw])))
    return {
        "g1_affine": convert.lv_to_ints(np.stack([np.asarray(xp), np.asarray(yp)], axis=1)),
        "g2_lanes": convert.lv_to_ints(np.asarray(sig_lanes.arr)),
        "g2_sum": convert.lv_to_ints(np.asarray(sig_sum.arr)),
        "miller": convert.lv_to_ints(np.asarray(fs)),
        "product": convert.lv_to_ints(np.asarray(ref_pairing.fp12_product(fs))),
        "extra_pair": convert.lv_to_ints(np.asarray(extra[0])),
    }


def _recorded_verdict(pk, h, sig, scalars) -> "tuple[bool, dict]":
    """One ``batch_verify_device`` through the plain versions, and each
    kernel's outputs recorded on the way."""
    seen: dict = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in ("g1_mul_affine", "g2_mul_sum", "miller_loop", "fp12_product"):
            def record(*args, _name=name, _fn=getattr(pairing, name)):
                out = _fn(*args)
                seen.setdefault(_name, []).append(out)
                return out
            mp.setattr(pairing, name, record)
        verdict = pairing.batch_verify_device(pk, h, sig, scalars, device="cpu")
    return verdict, seen


def _recorded_batch(batch) -> dict:
    """The batch's verdict and its stages: the one Miller call holds the
    sets' lanes, then the extra pair at lane n."""
    verdict, seen = _recorded_verdict(batch["pk"], batch["h"], batch["sig"], batch["scalars"])
    fs = seen["miller_loop"][0]
    return {
        "verdict": verdict,
        "words": pairing.scalar_words(batch["scalars"], "cpu"),
        "g1_affine": fq.to_ints(seen["g1_mul_affine"][0]),
        "g2_sum": fq.to_ints(seen["g2_mul_sum"][0]),
        "miller": fq.to_ints(fs[:LANES]),
        "miller_tensor": fs[:LANES],
        "miller_calls": len(seen["miller_loop"]),
        "extra_pair": fq.to_ints(fs[LANES:]),
        "product": fq.to_ints(seen["fp12_product"][0]),
        "tensors": {name: outs for name, outs in seen.items()},
    }


@pytest.fixture(scope="module")
def port(batch):
    return _recorded_batch(batch)


@pytest.fixture(scope="module")
def port_mxu(batch):
    """The same batch with every product of the plain versions on the mxu
    multiplier."""
    fq8.set_multiplier("mxu")
    try:
        return _recorded_batch(batch)
    finally:
        fq8.set_multiplier("u64")


@pytest.fixture
def mxu():
    fq8.set_multiplier("mxu")
    yield
    fq8.set_multiplier("u64")


# ---------------------------------------------------------------------------
# the tower
# ---------------------------------------------------------------------------


def _ref_lv(arr) -> ref_fql.LV:
    return ref_fql.LV(jnp.asarray(arr)[None], ref_fql._CANON_VMAX, 1 << 16)


def _ref_ints(lv) -> list:
    return convert.lv_to_ints(np.asarray(lv.arr)[0])


def test_fq2_matches_reference():
    rng = np.random.default_rng(2)
    a, b = [_rand_fq(rng) for _ in range(2)], [_rand_fq(rng) for _ in range(2)]
    ra, rb = _ref_lv(ref_fq2.to_lv(*a).arr), _ref_lv(ref_fq2.to_lv(*b).arr)
    pa, pb = fq2.from_ints(*a), fq2.from_ints(*b)
    assert list(fq2.to_ints(fq2.mul(pa, pb))) == _ref_ints(ref_fq2.mul(ra, rb))
    assert list(fq2.to_ints(fq2.square(pa))) == _ref_ints(ref_fq2.square(ra))
    assert list(fq2.to_ints(fq2.mul_by_xi(pa))) == _ref_ints(ref_fq2.mul_by_xi(ra))
    assert list(fq2.to_ints(fq2.conj(pa))) == _ref_ints(ref_fq2.conj(ra))
    assert list(fq2.to_ints(fq2.inv(pa))) == _ref_ints(ref_fq2.inv(ra))
    assert fq2.to_ints(fq2.inv(fq2.from_ints(0, 0))) == (0, 0)


def test_fq12_matches_reference():
    rng = np.random.default_rng(3)
    a, b = [_rand_fq(rng) for _ in range(12)], [_rand_fq(rng) for _ in range(12)]
    line = [[_rand_fq(rng) for _ in range(2)] for _ in range(3)]
    ra, rb = _ref_lv(ref_fq12.fp12_from_ints(a).arr), _ref_lv(ref_fq12.fp12_from_ints(b).arr)
    rline = [_ref_lv(ref_fq2.to_lv(*c).arr) for c in line]
    pa, pb = fq12.fp12_from_ints(a), fq12.fp12_from_ints(b)
    pline = [fq2.from_ints(*c) for c in line]
    assert fq12.fp12_to_ints(fq12.fp12_mul(pa, pb)) == _ref_ints(ref_fq12.fp12_mul(ra, rb))
    assert fq12.fp12_to_ints(fq12.fp12_sqr(pa)) == _ref_ints(ref_fq12.fp12_sqr(ra))
    assert fq12.fp12_to_ints(fq12.fp12_conj(pa)) == _ref_ints(ref_fq12.fp12_conj(ra))
    assert (fq12.fp12_to_ints(fq12.fp12_mul_by_line(pa, *pline))
            == _ref_ints(ref_fq12.fp12_mul_by_line(ra, *rline)))
    assert fq12.fp12_to_ints(fq12.fp12_mul(pa, pb)) == _fq12_ints(_fq12(a) * _fq12(b))


def test_field_inverse_and_conversions():
    rng = np.random.default_rng(4)
    values = [0, 1, P - 1] + [_rand_fq(rng) for _ in range(5)]
    mont = fq.to_mont(fq.limbs16(fq.from_ints(values)))
    assert fq.to_ints(fq.limbs32(fq.from_mont(fq.inv(mont)))) == [
        pow(v, P - 2, P) for v in values]
    assert fq.to_ints(fq.limbs32(fq.from_mont(mont))) == values


# ---------------------------------------------------------------------------
# the stages of batch_verify_device
# ---------------------------------------------------------------------------


def test_g1_blinder_multiplication_matches_reference(batch, reference, port):
    assert port["g1_affine"] == reference["g1_affine"]
    x, y = pairing.g1_mul_batched(pairing.g1_affine_from_raw(batch["pk"][2:], "cpu"),
                                  batch["scalars"][2:])
    assert fq.to_ints(torch.stack([x, y], dim=1)) == reference["g1_affine"][4:]


def test_g1_blinder_multiplication_matches_native(batch, port):
    for i, (raw, k) in enumerate(zip(batch["pk"], batch["scalars"])):
        out, inf = ref_native.g1_mul_raw(raw, False, k.to_bytes(32, "big"))
        assert not inf
        assert port["g1_affine"][2 * i : 2 * i + 2] == [
            int.from_bytes(out[:48], "big"), int.from_bytes(out[48:], "big")]


def test_g2_blinder_multiplication_and_sum_match_reference(batch, reference, port):
    assert port["g2_sum"] == reference["g2_sum"]
    # g2_sum_points on the reference's own lanes, and the odd width three
    lanes = fq.from_ints(reference["g2_lanes"]).reshape(LANES, 3, 2, 12)
    assert fq.to_ints(pairing.g2_sum_points(lanes)) == reference["g2_sum"]
    three = ref_pairing.g2_sum_points(ref_fql.LV(
        jnp.asarray(_lv_cols(reference["g2_lanes"][:18]).reshape(3, 3, 2, 24)),
        ref_fql._CANON_VMAX, 1 << 16))
    assert fq.to_ints(pairing.g2_sum_points(lanes[:3])) == convert.lv_to_ints(
        np.asarray(three.arr))
    # one lane's multiplication, limb for limb
    sig = pairing.g2_affine_from_raw(batch["sig"][1:2], "cpu")
    assert (fq.to_ints(pairing.g2_mul_batched(sig, batch["scalars"][1:2]))
            == reference["g2_lanes"][6:12])


def _lv_cols(values) -> np.ndarray:
    """Canonical ints -> the reference's R'-Montgomery columns."""
    return np.stack([ref_fql.to_mont_cols(v) for v in values])


def test_miller_values_match_reference_and_native(batch, reference, port):
    assert port["miller"] == reference["miller"]
    for i, h in enumerate(batch["h"]):
        blinded = port["g1_affine"][2 * i : 2 * i + 2]
        g1_raw = b"".join(v.to_bytes(48, "big") for v in blinded)
        assert port["miller"][12 * i : 12 * (i + 1)] == _raw576_ints(
            ref_native.miller_loop_raw(g1_raw, h))


def test_fp12_product_matches_reference(reference, port):
    """The product over the n + 1 lanes against the reference's product of
    the n Miller values times its extra pair (one Fq12 product: the same
    value in any order)."""
    assert port["product"] == _fq12_ints(_fq12(reference["product"])
                                         * _fq12(reference["extra_pair"]))
    # odd widths pad with one in the fold
    fs = port["miller_tensor"][:3]
    want = _fq12(port["miller"][:12]) * _fq12(port["miller"][12:24]) * _fq12(port["miller"][24:36])
    assert fq.to_ints(pairing.fp12_product(fs)) == _fq12_ints(want)
    assert fq.to_ints(pairing.fp12_product(fs[:1])) == port["miller"][:12]


def test_miller_product_matches_native(batch):
    g1s, g2s = batch["pk"][:2], batch["h"][:2]
    want = Fq12.one()
    for a, b in zip(g1s, g2s):
        want = want * _fq12(_raw576_ints(ref_native.miller_loop_raw(a, b)))
    assert pairing.miller_product_device(g1s, g2s, device="cpu") == _fq12_ints(want)


def test_batch_verdict_matches_reference(batch, reference, port):
    args = (batch["pk"], batch["h"], batch["sig"], batch["scalars"])
    assert ref_pairing.batch_verify_device(*args) is True
    assert port["verdict"] is True
    # the extra pair e(-G, sum): lane n of the one Miller call
    assert port["miller_calls"] == 1
    s_raw, _ = pairing._g2_point_to_raw(fq.from_ints(port["g2_sum"]).reshape(3, 2, 12))
    neg_g = pairing._neg_g1_generator_raw()
    assert port["extra_pair"] == _raw576_ints(ref_native.miller_loop_raw(neg_g, s_raw))
    assert port["extra_pair"] == reference["extra_pair"]


def _neg_raw(raw: bytes) -> bytes:
    """-P of a raw affine G1 (x || y) or G2 (x.c0 || x.c1 || y.c0 || y.c1)
    point."""
    half = len(raw) // 2
    ys = [(P - int.from_bytes(raw[i : i + 48], "big")) % P for i in range(half, len(raw), 48)]
    return raw[:half] + b"".join(y.to_bytes(48, "big") for y in ys)


def test_signature_sum_at_infinity_adds_no_lane(batch):
    """Sets (pk, H, sig) beside (-pk, H, -sig) under one blinder: the
    signature sum is infinity, so the Miller call holds the four lanes
    alone, and the verdict (true: the pairs cancel) is the reference's."""
    pk = [batch["pk"][0], _neg_raw(batch["pk"][0]), batch["pk"][1], _neg_raw(batch["pk"][1])]
    h = [batch["h"][0], batch["h"][0], batch["h"][1], batch["h"][1]]
    sig = [batch["sig"][0], _neg_raw(batch["sig"][0]), batch["sig"][1],
           _neg_raw(batch["sig"][1])]
    scalars = [batch["scalars"][1]] * 2 + [batch["scalars"][2]] * 2
    verdict, seen = _recorded_verdict(pk, h, sig, scalars)
    assert not bool(seen["g2_mul_sum"][0].any())
    assert [tuple(f.shape) for f in seen["miller_loop"]] == [(LANES, 2, 3, 2, 12)]
    assert verdict is True
    assert ref_pairing.batch_verify_device(pk, h, sig, scalars) is True


def test_verdict_of_an_incomplete_product_is_false(batch, port):
    """The signature sum of all four sets against the Miller product of
    three: the extra pair no longer cancels (a tampered batch's verdicts
    run in tests/test_torch_window.py)."""
    s_raw, s_inf = pairing._g2_point_to_raw(fq.from_ints(port["g2_sum"]).reshape(3, 2, 12))
    three = pairing.fp12_product(port["miller_tensor"][:3])
    assert pairing.finalize_verdict(three, s_raw, s_inf, device="cpu") is False
    f_ref = ref_fql.LV(jnp.asarray(_lv_cols(fq.to_ints(three)).reshape(2, 3, 2, 24)),
                       ref_fql._CANON_VMAX, 1 << 16)
    assert ref_pairing.finalize_verdict(f_ref, s_raw, s_inf) is False


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def test_dispatchers_take_plain_versions_for_cpu_tensors(port):
    before = dict(pairing.launch_counts)
    fs = port["miller_tensor"][:2]
    assert torch.equal(pairing.fp12_product(fs), pairing.fp12_product_plain(fs))
    assert pairing.launch_counts == before


def test_launchers_refuse_what_the_kernels_do_not_take(batch, port):
    pk = torch.stack(pairing.g1_affine_from_raw(batch["pk"], "cpu"), dim=1)
    words = port["words"]
    with pytest.raises(ValueError, match="CUDA tensors"):
        pairing.g1_mul_affine_cuda(pk, words)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pairing.fp12_product_cuda(port["miller_tensor"])
    with pytest.raises(TypeError):
        pairing.g1_mul_affine_plain(pk.to(torch.int64), words)
    with pytest.raises(ValueError):
        pairing.g1_mul_affine_plain(pk, words[:2])
    with pytest.raises(ValueError):
        pairing.miller_loop_plain(pk[:, 0], pk[:, 1], pk[:, 0], pk[:, 1])
    with pytest.raises(ValueError):
        pairing.scalar_words([1 << 128])
    with pytest.raises(ValueError):
        pairing.batch_verify_device(batch["pk"], batch["h"][:2], batch["sig"], batch["scalars"])


def test_fold_work_holds_every_level_of_either_build():
    """The Fq12 fold's work rows at the u64 build's 32 values a block (17
    partials at the window's 529) cover the mxu build's 64 (9)."""
    assert pairing._fold_work(529, pairing.FP12_FOLD_VALUES) == 17
    assert pairing._fold_work(529) == 9
    assert pairing._fold_work(1024, pairing.FP12_FOLD_VALUES) == 32
    for n in (1, 2, 33, 64, 65, 529, 1 << 12):
        assert pairing._fold_work(n, pairing.FP12_FOLD_VALUES) >= pairing._fold_work(n)


@pytest.mark.parametrize("value, want", [(None, 512), ("off", None), ("host", None),
                                         ("7", 7), ("0", None), ("x", ValueError)])
def test_pairing_threshold_from_the_environment(monkeypatch, value, want):
    if value is None:
        monkeypatch.delenv("ECT_PAIRING_MIN_SETS", raising=False)
    else:
        monkeypatch.setenv("ECT_PAIRING_MIN_SETS", value)
    if want is ValueError:
        with pytest.raises(ValueError, match="ECT_PAIRING_MIN_SETS"):
            _env.min_count("ECT_PAIRING_MIN_SETS", 512)
    else:
        assert _env.min_count("ECT_PAIRING_MIN_SETS", 512) == want


def test_install_sets_and_uninstall_clears_the_pairing_gate():
    ops.install(device="cpu")
    try:
        assert _device_flags.PAIRING_MIN_SETS == ops.DEFAULT_PAIRING_MIN_SETS
        assert not _device_flags.pairing_enabled(511)
        assert _device_flags.pairing_enabled(528) is (ops.DEFAULT_PAIRING_MIN_SETS is not None)
    finally:
        ops.uninstall()
    assert _device_flags.PAIRING_MIN_SETS is None
    assert not _device_flags.pairing_enabled(1 << 20)


# ---------------------------------------------------------------------------
# the mxu multiplier
# ---------------------------------------------------------------------------


def test_mxu_stages_equal_the_u64_stages(port, port_mxu):
    """Each of the four functions' outputs (the Miller kernel's once: the
    four lanes and the extra pair), tensor for tensor."""
    assert port_mxu["verdict"] is True
    for name, outs in port["tensors"].items():
        assert len(outs) == len(port_mxu["tensors"][name])
        for u64, mxu in zip(outs, port_mxu["tensors"][name]):
            assert torch.equal(u64, mxu), name


def test_mxu_tampered_verdict_matches_native(batch, mxu):
    """Two signatures swapped (the reference's tests/test_ops_pairing.py
    parity case): false on the mxu multiplier and in the native batch."""
    sig = list(batch["sig"])
    sig[1], sig[2] = sig[2], sig[1]
    assert pairing.batch_verify_device(batch["pk"], batch["h"], sig, batch["scalars"],
                                       device="cpu") is False
    sig96 = list(batch["sig96"])
    sig96[1], sig96[2] = sig96[2], sig96[1]
    blinders = [k.to_bytes(16, "big") for k in batch["scalars"]]
    assert ref_native.batch_verify_raw([([pk], m, s) for pk, m, s in zip(
        batch["pk"], batch["msg"], sig96)], ETH_DST, blinders) is False
    assert ref_native.batch_verify_raw([([pk], m, s) for pk, m, s in zip(
        batch["pk"], batch["msg"], batch["sig96"])], ETH_DST, blinders) is True


def test_mxu_set_sums_equal_the_u64_set_sums(batch, monkeypatch):
    """B6's plain version on three sets (one key; three; a repeat, P and
    -P, and an infinity lane) under both multipliers; the single-set sum
    makes no mxu product."""
    pk = batch["pk"]
    neg = pk[0][:48] + ((P - int.from_bytes(pk[0][48:], "big")) % P).to_bytes(48, "big")
    points, offsets = g1.sets_to_csr([pk[:1], pk[1:4], [pk[2], pk[2], pk[0], neg,
                                                       b"\x00" * 96]])
    u64 = g1.g1_sum_sets(points, offsets)
    fq8.set_multiplier("mxu")
    try:
        assert torch.equal(g1.g1_sum_sets(points, offsets), u64)
        # the single-set sum stays on u64 under mxu
        monkeypatch.setattr(fq8, "mont7r_plain", None)
        assert g1.aggregate_pubkeys_device(pk[1:4], device="cpu") == g1.jacobian_to_affine(
            u64[1:2])[0]
    finally:
        fq8.set_multiplier("u64")


def test_mxu_dispatchers_take_plain_versions_and_launchers_refuse_cpu(batch, port, mxu):
    before = (dict(pairing.launch_counts), g1.launch_count, g1.launch_count_mxu)
    fs = port["miller_tensor"][:2]
    assert torch.equal(pairing.fp12_product(fs), pairing.fp12_product_plain(fs))
    assert (dict(pairing.launch_counts), g1.launch_count, g1.launch_count_mxu) == before
    pk = torch.stack(pairing.g1_affine_from_raw(batch["pk"], "cpu"), dim=1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pairing.g1_mul_affine_cuda(pk, port["words"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        pairing.fp12_product_cuda(port["miller_tensor"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        g1.g1_sum_sets_cuda(*g1.sets_to_csr([batch["pk"]]))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_kernels_match_plain_on_card(cuda, batch, port):
    words = port["words"].to(cuda)
    pk = torch.stack(pairing.g1_affine_from_raw(batch["pk"], cuda), dim=1).contiguous()
    sig = torch.stack(pairing.g2_affine_from_raw(batch["sig"], cuda), dim=1).contiguous()
    got = pairing.g1_mul_affine(pk, words)
    assert fq.to_ints(got) == port["g1_affine"]
    assert fq.to_ints(pairing.g2_mul_sum(sig, words)) == port["g2_sum"]
    xq, yq = (v.contiguous() for v in pairing.g2_affine_from_raw(batch["h"], cuda))
    fs = pairing.miller_loop(got[:, 0].contiguous(), got[:, 1].contiguous(), xq, yq)
    assert fq.to_ints(fs) == port["miller"]
    assert fq.to_ints(pairing.fp12_product(fs)) == port["product"]
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# fp_tower.h on the host
# ---------------------------------------------------------------------------

_HOST_SHIM = r"""
#include "fp_tower.h"
using namespace tower;

static Fp ld(const uint32_t* p) { Fp r; for (int i = 0; i < 12; ++i) r.v[i] = p[i]; return fp381::to_mont(r); }
static void st(uint32_t* p, const Fp& a) { const Fp c = fp381::from_mont(a); for (int i = 0; i < 12; ++i) p[i] = c.v[i]; }
static Fp2 ld2(const uint32_t* p) { return Fp2{ld(p), ld(p + 12)}; }
static void st2(uint32_t* p, const Fp2& a) { st(p, a.c0); st(p + 12, a.c1); }
static Fp12 ld12(const uint32_t* p) {
  return Fp12{Fp6{ld2(p), ld2(p + 24), ld2(p + 48)}, Fp6{ld2(p + 72), ld2(p + 96), ld2(p + 120)}};
}
static void st12(uint32_t* p, const Fp12& a) {
  st2(p, a.c0.a0); st2(p + 24, a.c0.a1); st2(p + 48, a.c0.a2);
  st2(p + 72, a.c1.a0); st2(p + 96, a.c1.a1); st2(p + 120, a.c1.a2);
}
static G2Jac ldj(const uint32_t* p) { return G2Jac{ld2(p), ld2(p + 24), ld2(p + 48)}; }
static void stj(uint32_t* p, const G2Jac& a) { st2(p, a.x); st2(p + 24, a.y); st2(p + 48, a.z); }

extern "C" void fp_inv_h(const uint32_t* a, uint32_t* o) { st(o, fp_inv(ld(a))); }
extern "C" void fp2_mul_h(const uint32_t* a, const uint32_t* b, uint32_t* o) { st2(o, fp2_mul(ld2(a), ld2(b))); }
extern "C" void fp2_sqr_h(const uint32_t* a, const uint32_t* b, uint32_t* o) { (void)b; st2(o, fp2_sqr(ld2(a))); }
extern "C" void fp2_inv_h(const uint32_t* a, const uint32_t* b, uint32_t* o) { (void)b; st2(o, fp2_inv(ld2(a))); }
extern "C" void fp12_mul_h(const uint32_t* a, const uint32_t* b, uint32_t* o) { st12(o, fp12_mul(ld12(a), ld12(b))); }
extern "C" void fp12_sqr_h(const uint32_t* a, const uint32_t* b, uint32_t* o) { (void)b; st12(o, fp12_sqr(ld12(a))); }
extern "C" void fp12_line_h(const uint32_t* f, const uint32_t* c, uint32_t* o) {
  st12(o, fp12_mul_by_line(ld12(f), ld2(c), ld2(c + 24), ld2(c + 48)));
}
extern "C" void miller_h(const uint32_t* g1, const uint32_t* g2, uint32_t* o) {
  st12(o, miller_loop(ld(g1), ld(g1 + 12), ld2(g2), ld2(g2 + 24)));
}
// the kernel's lane: [k] P, then affine through the inversion
extern "C" void g1_mul_affine_h(const uint32_t* pt, const uint32_t* k, uint32_t* o) {
  const G1Jac acc = g1_mul(G1Jac{ld(pt), ld(pt + 12), fp381::one_mont()}, k);
  const Fp zi = fp_inv(acc.z), zi2 = fp381::sqr(zi);
  st(o, fp381::mul(acc.x, zi2));
  st(o + 12, fp381::mul(acc.y, fp381::mul(zi2, zi)));
}
extern "C" void g2_mul_h(const uint32_t* pt, const uint32_t* k, uint32_t* o) {
  stj(o, g2_mul(G2Jac{ld2(pt), ld2(pt + 24), fp2_one()}, k));
}
extern "C" void g2_add_h(const uint32_t* p, const uint32_t* q, uint32_t* o) { stj(o, g2_add(ldj(p), ldj(q))); }
"""


@pytest.fixture(scope="module")
def tower_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("fp_tower")
    shim = tmp / "shim.cpp"
    shim.write_text(_HOST_SHIM)
    lib_path = tmp / "libfp_tower.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-Wall", "-Werror", "-shared", "-fPIC",
                    f"-I{CSRC}", str(shim), "-o", str(lib_path)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("fp2_mul_h", "fp2_sqr_h", "fp2_inv_h", "fp12_mul_h", "fp12_sqr_h", "fp12_line_h",
                 "miller_h", "g1_mul_affine_h", "g2_mul_h", "g2_add_h"):
        getattr(lib, name).argtypes = [ctypes.c_void_p] * 3
        getattr(lib, name).restype = None
    lib.fp_inv_h.argtypes = [ctypes.c_void_p] * 2
    lib.fp_inv_h.restype = None
    return lib


def _limbs(values) -> np.ndarray:
    return np.ascontiguousarray(
        fq.from_ints(list(values)).numpy().view(np.uint32).reshape(-1))


def _ints(limbs: np.ndarray) -> list:
    return fq.to_ints(torch.from_numpy(limbs.view(np.int32)))


def _call(fn, *inputs, out_words: int) -> list:
    args = [np.ascontiguousarray(a) for a in inputs]
    out = np.zeros(out_words, dtype=np.uint32)
    fn(*(a.ctypes.data for a in args), out.ctypes.data)
    return _ints(out)


def test_tower_header_matches_python_integers(tower_lib):
    rng = np.random.default_rng(6)
    a, b = [_rand_fq(rng) for _ in range(12)], [_rand_fq(rng) for _ in range(12)]
    fa, fb = Fq2(Fq(a[0]), Fq(a[1])), Fq2(Fq(b[0]), Fq(b[1]))
    la, lb = _limbs(a), _limbs(b)

    def f2(x):
        return [x.c0.n, x.c1.n]

    assert _call(tower_lib.fp2_mul_h, la[:24], lb[:24], out_words=24) == f2(fa * fb)
    assert _call(tower_lib.fp2_sqr_h, la[:24], lb[:24], out_words=24) == f2(fa * fa)
    assert _call(tower_lib.fp2_inv_h, la[:24], lb[:24], out_words=24) == f2(fa.inverse())
    assert _call(tower_lib.fp12_mul_h, la, lb, out_words=144) == _fq12_ints(_fq12(a) * _fq12(b))
    assert _call(tower_lib.fp12_sqr_h, la, lb, out_words=144) == _fq12_ints(_fq12(a) * _fq12(a))
    c00, c11, c12 = (Fq2(Fq(b[i]), Fq(b[i + 1])) for i in (0, 2, 4))
    zero = Fq2(Fq(0), Fq(0))
    line = Fq12(Fq6(c00, zero, zero), Fq6(zero, c11, c12))
    assert (_call(tower_lib.fp12_line_h, la, lb[:72], out_words=144)
            == _fq12_ints(_fq12(a) * line))
    for v in (0, 1, a[0]):
        out = np.zeros(12, dtype=np.uint32)
        tower_lib.fp_inv_h(_limbs([v]).ctypes.data, out.ctypes.data)
        assert _ints(out) == [pow(v, P - 2, P)]


def test_tower_header_miller_loop_matches_native(tower_lib, batch):
    for g1, g2 in zip(batch["pk"], batch["h"]):
        g1_limbs = pairing._coords([g1], 2).numpy().view(np.uint32).reshape(-1)
        g2_limbs = pairing._coords([g2], 4).numpy().view(np.uint32).reshape(-1)
        assert _call(tower_lib.miller_h, g1_limbs, g2_limbs, out_words=144) == _raw576_ints(
            ref_native.miller_loop_raw(g1, g2))


def test_tower_header_points_match_plain_versions(tower_lib, batch, reference, port):
    words = port["words"].numpy().view(np.uint32)
    for i, raw in enumerate(batch["pk"]):
        pt = pairing._coords([raw], 2).numpy().view(np.uint32).reshape(-1)
        assert (_call(tower_lib.g1_mul_affine_h, pt, words[i], out_words=24)
                == port["g1_affine"][2 * i : 2 * i + 2])
    lanes = []
    for i, raw in enumerate(batch["sig"]):
        pt = pairing._coords([raw], 4).numpy().view(np.uint32).reshape(-1)
        lanes.append(np.asarray(
            _limbs(_call(tower_lib.g2_mul_h, pt, words[i], out_words=72))))
        assert _ints(lanes[-1]) == reference["g2_lanes"][6 * i : 6 * (i + 1)]
    # the kernel's fold: neighbours first
    left = _call(tower_lib.g2_add_h, lanes[0], lanes[1], out_words=72)
    right = _call(tower_lib.g2_add_h, lanes[2], lanes[3], out_words=72)
    assert _call(tower_lib.g2_add_h, _limbs(left), _limbs(right), out_words=72) == port["g2_sum"]
