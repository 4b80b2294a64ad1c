"""The port's KZG commitments (``crypto/kzg.py``) against the reference package.

Three setups: the insecure dev setup at n = 64 (as ``tests/test_kzg.py``
builds it) on the native form and on the pure-Python form, and the mainnet
ceremony at 4096 on the native form. On each, the same seeded blobs give
byte-equal commitments and proofs, the three verifications give equal
verdicts on good and on changed inputs, and a non-canonical blob or a
commitment that is no curve point raises ``KzgError`` in both. The port's
ceremony files are byte-equal to the reference's, and ``ceremony()`` reads
them from the port's own ``crypto/data/``.
"""

import builtins
import contextlib
import hashlib
from pathlib import Path

import numpy as np
import pytest

from ethereum_consensus_tpu.crypto import bls as ref_bls
from ethereum_consensus_tpu.crypto import kzg as ref_kzg
from ethereum_consensus_tpu_torch.crypto import bls as port_bls
from ethereum_consensus_tpu_torch.crypto import kzg as port_kzg
from ethereum_consensus_tpu_torch.crypto.fields import R

REPO = Path(__file__).resolve().parents[1]
PORT_DATA = REPO / "ethereum_consensus_tpu_torch" / "crypto" / "data"
REF_DATA = REPO / "ethereum_consensus_tpu" / "crypto" / "data"
DEV_TAU = 0xDEADBEEF1234
DEV_N = 64
# (backend, setup): the pure-Python form only at the dev size
SETUPS = {"dev_native": ("native", "dev"), "dev_python": ("python", "dev"),
          "ceremony_native": ("native", "ceremony")}
_SETTINGS: dict = {}


@contextlib.contextmanager
def _backend(name: str):
    """Both packages' KZG on one form (``_native_on`` reads the BLS backend)."""
    saved = ref_bls._BACKEND, port_bls._BACKEND
    ref_bls._BACKEND = port_bls._BACKEND = name
    try:
        yield
    finally:
        ref_bls._BACKEND, port_bls._BACKEND = saved


class Pair:
    """One setup in both packages, on one backend."""

    def __init__(self, name: str):
        self.name = name
        self.backend, kind = SETUPS[name]
        with self.on():
            if name not in _SETTINGS:
                if kind == "dev":
                    _SETTINGS[name] = (
                        ref_kzg.KzgSettings.insecure_dev_setup(tau=DEV_TAU, n=DEV_N),
                        port_kzg.KzgSettings.insecure_dev_setup(tau=DEV_TAU, n=DEV_N))
                else:
                    _SETTINGS[name] = (ref_kzg.KzgSettings.ceremony(),
                                       port_kzg.KzgSettings.ceremony())
        self.ref, self.port = _SETTINGS[name]
        self.n = self.port.n

    def on(self):
        return _backend(self.backend)

    def both(self, fn: str, *args):
        """``fn`` of each package on ``args``: (reference, port) results, an
        error as its class's name."""
        out = []
        for module, settings in ((ref_kzg, self.ref), (port_kzg, self.port)):
            try:
                with self.on():
                    out.append(getattr(module, fn)(*args, settings))
            except Exception as exc:  # noqa: BLE001 — the error is the result
                out.append(type(exc).__name__)
        return tuple(out)


@pytest.fixture(params=list(SETUPS))
def pair(request):
    return Pair(request.param)


def _blob(n: int, seed: int) -> bytes:
    """n seeded canonical field elements (31 random bytes under a zero)."""
    rng = np.random.default_rng(seed)
    return b"".join(b"\x00" + rng.bytes(31) for _ in range(n))


def _fr(v: int) -> bytes:
    return (v % R).to_bytes(32, "big")


def test_setups_agree(pair):
    assert pair.ref.n == pair.port.n
    assert pair.ref.roots_brp == pair.port.roots_brp
    assert [p.serialize() for p in pair.ref.g1_lagrange_brp] == \
        [p.serialize() for p in pair.port.g1_lagrange_brp]
    assert [p.serialize() for p in pair.ref.g2_monomial[:2]] == \
        [p.serialize() for p in pair.port.g2_monomial[:2]]


def test_commitments_and_proofs_are_byte_equal(pair):
    blob = _blob(pair.n, 1)
    ref_c, port_c = pair.both("blob_to_kzg_commitment", blob)
    assert bytes(port_c) == bytes(ref_c) and len(ref_c) == 48
    # a point off the domain, and one on it (the quotient's special column)
    for z in (_fr(0x123456789), _fr(pair.port.roots_brp[5])):
        (ref_proof, ref_y), (port_proof, port_y) = pair.both("compute_kzg_proof", blob, z)
        assert (bytes(port_proof), port_y) == (bytes(ref_proof), ref_y)
    ref_p, port_p = pair.both("compute_blob_kzg_proof", blob, ref_c)
    assert bytes(port_p) == bytes(ref_p)


def test_verdicts_are_equal(pair):
    # the inputs from the port's native form (the forms' outputs are
    # byte-equal, above); the verifications on the pair's own form
    blobs = [_blob(pair.n, seed) for seed in (2, 3)]
    z = _fr(0xABCDEF)
    with _backend("native"):
        commitments = [port_kzg.blob_to_kzg_commitment(b, pair.port) for b in blobs]
        proofs = [port_kzg.compute_blob_kzg_proof(b, c, pair.port)
                  for b, c in zip(blobs, commitments)]
        point_proof, y = port_kzg.compute_kzg_proof(blobs[0], z, pair.port)
    wrong_y = _fr(int.from_bytes(y, "big") + 1)
    cases = [
        ("verify_kzg_proof", (commitments[0], z, y, point_proof), True),
        ("verify_kzg_proof", (commitments[0], z, wrong_y, point_proof), False),
        ("verify_blob_kzg_proof", (blobs[0], commitments[0], proofs[0]), True),
        ("verify_blob_kzg_proof", (blobs[0], commitments[0], proofs[1]), False),
        ("verify_blob_kzg_proof_batch", (blobs, commitments, proofs), True),
        ("verify_blob_kzg_proof_batch", (blobs, commitments, proofs[::-1]), False),
    ]
    if pair.backend == "python":
        # a pure-Python pairing costs about a second: each function once,
        # a true and a false verdict each from two of them
        cases = cases[0::3] + cases[4:]
    for fn, args, want in cases:
        assert pair.both(fn, *args) == (want, want), (fn, want)


def test_bad_inputs_raise_kzg_error_in_both(pair):
    blob = _blob(pair.n, 4)
    commitment = pair.both("blob_to_kzg_commitment", blob)[1]
    proof = pair.both("compute_blob_kzg_proof", blob, commitment)[1]
    non_canonical = blob[:32 * 7] + R.to_bytes(32, "big") + blob[32 * 8:]
    garbage = b"\x11" * 48  # compression flag unset: no point
    cases = [
        ("blob_to_kzg_commitment", (non_canonical,)),
        ("compute_blob_kzg_proof", (non_canonical, commitment)),
        ("verify_blob_kzg_proof", (non_canonical, commitment, proof)),
        ("compute_blob_kzg_proof", (blob, garbage)),
        ("verify_blob_kzg_proof", (blob, garbage, proof)),
        ("verify_blob_kzg_proof_batch", ([blob, blob], [commitment, garbage], [proof, proof])),
    ]
    for fn, args in cases:
        assert pair.both(fn, *args) == ("KzgError", "KzgError"), fn


@pytest.mark.parametrize("name", ["trusted_setup.json", "trusted_setup_affine.bin"])
def test_ceremony_files_are_the_reference_bytes(name):
    port, ref = (PORT_DATA / name).read_bytes(), (REF_DATA / name).read_bytes()
    assert port == ref
    if name.endswith(".bin"):
        assert hashlib.sha256(port).hexdigest() == port_kzg.CEREMONY_AFFINE_SHA256


def test_ceremony_reads_the_ports_own_files(monkeypatch):
    opened = []
    real_open = builtins.open

    def recording(path, *args, **kwargs):
        opened.append(Path(path).resolve())
        return real_open(path, *args, **kwargs)

    monkeypatch.setattr(port_kzg, "_CEREMONY", None)
    monkeypatch.setattr(builtins, "open", recording)
    with _backend("native"):
        settings = port_kzg.KzgSettings.ceremony()
    monkeypatch.setattr(builtins, "open", real_open)
    assert opened == [PORT_DATA / "trusted_setup_affine.bin"]
    assert settings.n == port_kzg.FIELD_ELEMENTS_PER_BLOB
    with _backend("native"):
        assert settings.g1_raw() == ref_kzg.KzgSettings.ceremony().g1_raw()
