"""The port's BLS signatures against the reference package.

Both packages run their native backend (the same C++ library, built from
each package's own copy). ``SecretKey.sign`` gives the same bytes;
``verify_signature``, ``fast_aggregate_verify`` and
``verify_signature_sets`` give the same verdicts, also for a signature with
one flipped byte and for swapped signatures. A committee's aggregate
signature made under the summed secret key (the trick the chip smoke run
uses to sign 64 committees quickly) equals ``aggregate`` of the members'
signatures. The batch path is also run with the port's G1 aggregation
routed to the kernel's plain version.
"""

import pytest

from ethereum_consensus_tpu.crypto import bls as ref_bls
from ethereum_consensus_tpu.crypto.fields import R
from ethereum_consensus_tpu_torch import _device_flags
from ethereum_consensus_tpu_torch.crypto import bls as port_bls
from ethereum_consensus_tpu_torch.ops import g1 as port_g1
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

MESSAGES = [bytes([i]) * 32 for i in range(4)]


def _keys(lib, first, n):
    sks = [lib.SecretKey(first + i) for i in range(n)]
    return sks, [sk.public_key() for sk in sks]


def _outcome(fn):
    """The verdict, or the error class if the call raises."""
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 — the class is what is compared
        return type(exc).__name__


def _flip(sig: bytes, at: int) -> bytes:
    return sig[:at] + bytes([sig[at] ^ 0x01]) + sig[at + 1 :]


def test_backends_are_native():
    assert port_bls.backend_name() == ref_bls.backend_name() == "native"


def test_sign_and_public_key_bytes_match():
    for i in (1, 2, 3, 1000, R - 1):
        port_sk, ref_sk = port_bls.SecretKey(i), ref_bls.SecretKey(i)
        assert port_sk.public_key().to_bytes() == ref_sk.public_key().to_bytes()
        for msg in MESSAGES:
            assert port_sk.sign(msg).to_bytes() == ref_sk.sign(msg).to_bytes()


@pytest.mark.parametrize("tamper", ["none", "flip_last", "flip_first", "wrong_message"])
def test_verify_verdicts_match(tamper):
    def run(lib):
        sk = lib.SecretKey(7)
        sig = sk.sign(MESSAGES[0]).to_bytes()
        msg = MESSAGES[1] if tamper == "wrong_message" else MESSAGES[0]
        if tamper == "flip_last":
            sig = _flip(sig, 95)
        elif tamper == "flip_first":
            sig = _flip(sig, 0)
        return _outcome(lambda: lib.verify_signature(
            sk.public_key(), msg, lib.Signature.from_bytes(sig)))

    assert run(port_bls) == run(ref_bls)
    if tamper == "none":
        assert run(port_bls) is True


@pytest.mark.parametrize("tamper", ["none", "flip_last", "drop_key"])
def test_fast_aggregate_verify_verdicts_match(tamper):
    def run(lib):
        sks, pks = _keys(lib, 11, 9)
        sig = lib.aggregate([sk.sign(MESSAGES[2]) for sk in sks]).to_bytes()
        if tamper == "flip_last":
            sig = _flip(sig, 95)
        if tamper == "drop_key":
            pks = pks[1:]
        return _outcome(lambda: lib.fast_aggregate_verify(
            pks, MESSAGES[2], lib.Signature.from_bytes(sig)))

    assert run(port_bls) == run(ref_bls)


def _sets(lib, tamper):
    out = []
    for s in range(4):
        sks, pks = _keys(lib, 100 + 10 * s, s + 1)
        sig = lib.aggregate([sk.sign(MESSAGES[s]) for sk in sks]).to_bytes()
        out.append([pks, MESSAGES[s], sig])
    if tamper == "swap":
        out[1][2], out[2][2] = out[2][2], out[1][2]
    elif tamper == "flip":
        out[3][2] = _flip(out[3][2], 95)
    return out


def _set_verdicts(lib, tamper):
    def run():
        sets = [lib.SignatureSet(pks, msg, lib.Signature.from_bytes(sig))
                for pks, msg, sig in _sets(lib, tamper)]
        return lib.verify_signature_sets(sets)
    return _outcome(run)


@pytest.mark.parametrize("tamper", ["none", "swap", "flip"])
def test_verify_signature_sets_verdicts_match(tamper):
    ref = _set_verdicts(ref_bls, tamper)
    assert _set_verdicts(port_bls, tamper) == ref
    if tamper == "swap":
        assert ref == [True, False, False, True]


@pytest.mark.parametrize("tamper", ["none", "swap"])
def test_verify_signature_sets_through_plain_g1_route(monkeypatch, tamper):
    monkeypatch.setattr(_device_flags, "BLS_AGG_MIN_N", 1)
    monkeypatch.setattr(_device_flags, "DEVICE", "cpu")
    before = port_g1.launch_count
    calls = []
    plain = port_g1.g1_sum_sets_plain
    monkeypatch.setattr(port_g1, "g1_sum_sets_plain",
                        lambda *a: calls.append(1) or plain(*a))
    assert _set_verdicts(port_bls, tamper) == _set_verdicts(ref_bls, tamper)
    assert calls, "the aggregation did not take the kernel's route"
    assert port_g1.launch_count == before


def test_summed_key_signature_equals_aggregate_of_singles():
    """A committee of 16 keys SecretKey(i + 1): one signature under the
    secret key sum(i + 1) mod r is the aggregate of the 16 signatures."""
    members = [3 * i + 5 for i in range(16)]
    msg = MESSAGES[3]
    singles = [port_bls.SecretKey(i + 1).sign(msg) for i in members]
    summed = port_bls.SecretKey(sum(i + 1 for i in members) % R).sign(msg)
    assert summed.to_bytes() == port_bls.aggregate(singles).to_bytes()
    assert summed.to_bytes() == ref_bls.aggregate(
        [ref_bls.SecretKey(i + 1).sign(msg) for i in members]).to_bytes()
    pks = [port_bls.SecretKey(i + 1).public_key() for i in members]
    assert port_bls.fast_aggregate_verify(pks, msg, summed)


@pytest.mark.parametrize("spread", ["consecutive", "sparse", "jumps"])
def test_small_secret_keys_in_one_batch(spread):
    """native small_sk_to_pk_batch (the walk by additions of the generator
    that chip_smoke.py makes its real keys with) gives the reference's
    public key of each SecretKey(k): consecutive keys (doublings among
    them), keys a few apart, and gaps past the walk's limit of 64."""
    import random

    from ethereum_consensus_tpu_torch.native import bls as native

    rng = random.Random(len(spread))
    keys = {"consecutive": list(range(1, 130)),
            "sparse": sorted(rng.sample(range(1, 4096), 300)),
            "jumps": [1, 66, 67, 2**20, 2**20 + 64, 2**20 + 65, 2**40, 2**64 - 1]}[spread]
    want = [ref_bls.SecretKey(k).public_key().to_bytes() for k in keys]
    assert native.small_sk_to_pk_batch(keys) == want
    assert native.small_sk_to_pk_batch([]) == []
    for bad in ([0, 1], [5, 4], [2**64]):
        with pytest.raises(ValueError):
            native.small_sk_to_pk_batch(bad)
