"""The int8 tensor-core Montgomery product (B8) and the multiplier switch.

The reference (ethereum_consensus_tpu/ops/fq8.py) shapes the Montgomery
product of its pairing field for a matrix unit whose integer path is
int8 x int8 -> int32: split each operand into signed-int8 digits, form
every column of the schoolbook product with one batched integer matrix
product, then reduce byte by byte. ``fql.set_multiplier("mxu")`` (or
``EC_PAIRING_MULT=mxu``) routes every product of its pairing tower
through ``mont7r``. The port has no ``fql.py``: its tower is the strict
field of ops/fq.py, so the switch lives here, and ``mul`` is the product
that the plain versions of the pairing and set-sum kernels call.

The plain versions below work on the port's strict field: ``(..., 24)``
int64 16-bit limbs in Montgomery form with R = 2^384, canonical in and
out (ops/fq.py). Each is the counterpart of the reference function of
the same name:

  - ``_to7r``, ``product_cols7r``, ``_reduce8`` and ``mont7r``: the routed
    chain. The 58 seven-bit digits of each operand (``L7R``), the 115
    digit columns from one batched integer matmul
    ``(..., 1, 58) @ (..., 58, 115)``, their regrouping to byte weight
    (``_R7_Q``, ``_R7_S``), 48 byte rounds of Montgomery reduction
    (R = 2^384 = 2^(8·48), where the reference takes 52 for its
    R' = 2^416; the plain version takes their 48 digits together, as
    the kernels take the whole reduction as products: m = (T mod 2^384)
    n' mod 2^384, then T + m p) and one conditional subtraction. The
    output is the canonical a·b·2^-384 mod p, equal bit for bit to
    ``fq.mul``.
  - ``product_cols8``/``mont8`` (48 bytes, the outer product contracted
    with a constant 0/1 matrix) and ``product_cols7``/``mont7`` (55
    seven-bit digits): the variants that only the reference's tests call.

``lv_mont8`` and ``carry_norm`` have no counterpart: they manage the
redundancy of the reference's lazy field, which the strict field does
not have.

On the card, ``mont7r_cuda`` runs the batched product of n operand pairs
(csrc/mont_mxu.cu: tiles of 16 products a warp on ``mma.sync`` int8
tensor-core steps, the reductions GEMMs over the tile; csrc/fp_mma.h holds
the arithmetic). Under ``"mxu"`` the pairing and set-sum wrappers launch
their mxu builds (ops/pairing.py, ops/g1.py), one warp a product.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from .. import _env, _kernels
from ..telemetry import device as _obs
from . import fq

__all__ = [
    "L7R",
    "MULTIPLIERS",
    "from_mont",
    "get_multiplier",
    "inv",
    "launch_counts",
    "mont7",
    "mont7r",
    "mont7r_cuda",
    "mont7r_plain",
    "mont8",
    "mul",
    "pinned",
    "product_cols7",
    "product_cols7r",
    "product_cols8",
    "set_multiplier",
    "to_mont",
]

MULTIPLIERS = _env.MULTIPLIERS

L8 = 48  # bytes of a 384-bit value
COLS8 = 2 * L8 - 1
L7 = 55  # 7-bit digits of a 24-limb value (55 * 7 = 385)
COLS7 = 2 * L7 - 1
L7R = 58  # 7-bit digits of 25 limbs (406 >= 400 bits), the reference's
COLS7R = 2 * L7R - 1
# byte columns of the regrouped product: the top 7-bit column lands in
# byte (7 * 114) // 8 = 99
T_COLS = 2 * L8 + 4

# Kernel launches since the count was last set to 0.
launch_counts = {"mont_mxu": 0}

# ---------------------------------------------------------------------------
# The switch (the reference's fql.set_multiplier / get_multiplier)
# ---------------------------------------------------------------------------

_MULTIPLIER = _env.multiplier()
_PINNED = threading.local()


def set_multiplier(kind: str) -> None:
    """Select the product of the pairing and set-sum path: "u64" (the CIOS
    product, ops/fq.py and csrc/fp381_core.h) or "mxu" (this module's
    int8 digit product). Any other kind raises ValueError."""
    global _MULTIPLIER
    if kind not in MULTIPLIERS:
        raise ValueError(f"multiplier must be one of {MULTIPLIERS}, got {kind!r}")
    _MULTIPLIER = kind


def get_multiplier() -> str:
    """The selected multiplier: this thread's pin, else the switch."""
    return getattr(_PINNED, "kind", None) or _MULTIPLIER


@contextlib.contextmanager
def pinned(kind: str):
    """Run the block on this thread with the multiplier ``kind``, whatever
    the switch says (the single-set aggregation stays on u64)."""
    if kind not in MULTIPLIERS:
        raise ValueError(f"multiplier must be one of {MULTIPLIERS}, got {kind!r}")
    before = getattr(_PINNED, "kind", None)
    _PINNED.kind = kind
    try:
        yield
    finally:
        _PINNED.kind = before


# ---------------------------------------------------------------------------
# Digits and columns
# ---------------------------------------------------------------------------

_R7_Q = torch.tensor([(7 * i) // 8 for i in range(COLS7R)])
_R7_S = torch.tensor([(7 * i) % 8 for i in range(COLS7R)])
# the constant anti-diagonal contraction of mont8: (i * 48 + j, k) -> [i + j == k]
_M8 = torch.zeros((L8 * L8, COLS8), dtype=torch.float64)
_M8[torch.arange(L8 * L8), (torch.arange(L8)[:, None] + torch.arange(L8)[None, :]).flatten()] = 1
_N_PRIME = (-pow(fq.P_INT, -1, fq.R)) % fq.R
# rows a plain product takes at once: the Toeplitz operand of 2^14 rows is
# 0.9 GB in float64
CHUNK = 1 << 14
_ON: dict = {}


def _on(t: torch.Tensor, device) -> torch.Tensor:
    key = (id(t), str(device))
    out = _ON.get(key)
    if out is None:
        out = _ON[key] = t.to(device)
    return out


def _digit_index(width: int, count: int) -> "tuple[torch.Tensor, ...]":
    """For each ``width``-bit digit of 16-bit limbs: its limb, the next
    limb, its bit offset in its limb and the shift of the next limb."""
    q = torch.tensor([(width * d) // 16 for d in range(count)])
    r = torch.tensor([(width * d) % 16 for d in range(count)])
    return q, q + 1, r, 16 - r


_DIGITS = {(7, L7R): _digit_index(7, L7R), (7, L7): _digit_index(7, L7),
           (8, L8): _digit_index(8, L8)}


def _digits(cols: torch.Tensor, width: int, count: int) -> torch.Tensor:
    """(..., 24) 16-bit limbs -> (..., count) digits of ``width`` bits
    (int64 in [0, 2^width)). A digit takes its limb's bits from its offset
    and the next limb's above them; bits past the value are 0."""
    index = _DIGITS[(width, count)]
    padded = torch.constant_pad_nd(cols, (0, int(index[1][-1]) + 1 - cols.shape[-1]))
    q, q1, r, r1 = (_on(t, cols.device) for t in index)
    v = (padded[..., q] >> r) | (padded[..., q1] << r1)
    return v & ((1 << width) - 1)


def _to7r(cols: torch.Tensor) -> torch.Tensor:
    """(..., 24) 16-bit limbs -> (..., 58) 7-bit digits, each in [0, 127]:
    the reference's ``_to7r(carry_norm(cols))`` (its 25th column is 0
    for a strict-field value)."""
    return _digits(cols, 7, L7R)


def _toeplitz_product(a: torch.Tensor, b: torch.Tensor, count: int) -> torch.Tensor:
    """The 2 count - 1 columns of the product of two ``count``-digit 7-bit
    vectors, cols[k] = sum_j a7[k - j] b7[j], as one batched matmul
    (..., 2 count - 1, count) @ (..., count, 1) whose left operand is the
    sliding window of a's zero-padded digits: float64, exact, since every
    column is an integer below 2^21 (torch has no integer matmul on the
    card, and on the CPU its int64 one is ten times slower)."""
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape[:-1]
    a7, b7 = _digits(torch.stack([a, b]).reshape(2, -1, fq.LIMBS), 7, count).to(
        torch.float64).unbind(0)
    window = torch.constant_pad_nd(a7, (count - 1, count - 1)).unfold(-1, count, 1)
    cols = torch.bmm(window, b7.flip(-1)[..., None])[..., 0]
    return cols.to(torch.int64).reshape(*shape, 2 * count - 1)


def product_cols7r(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 24) x (..., 24) -> the exact (..., 115) 7-bit-weighted columns
    of a * b on 58 digits (each below 2^20: 58 products of at most 127^2)."""
    return _toeplitz_product(a, b, L7R)


def product_cols7(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 24) x (..., 24) -> the exact (..., 109) 7-bit-weighted columns
    of a * b on 55 digits (the reference's product_cols7)."""
    return _toeplitz_product(a, b, L7)


def product_cols8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 24) x (..., 24) -> the exact (..., 95) byte-weighted columns of
    a * b: the 48 x 48 outer product of the bytes contracted with the
    constant anti-diagonal matrix (the reference's product_cols8; float64,
    exact: each column below 2^22)."""
    a, b = torch.broadcast_tensors(a, b)
    a8 = _digits(a, 8, L8).to(torch.float64)
    b8 = _digits(b, 8, L8).to(torch.float64)
    outer = (a8[..., :, None] * b8[..., None, :]).flatten(-2)
    return (outer @ _on(_M8, a.device)).to(torch.int64)


# ---------------------------------------------------------------------------
# The byte-granular reduction and the products
# ---------------------------------------------------------------------------


def _regroup7(cols7: torch.Tensor) -> torch.Tensor:
    """7-bit-weighted columns -> (..., 100) byte-weighted columns of the
    same integer: column i (weight 2^(7i)) goes to byte (7i) // 8, shifted
    by (7i) % 8 (a byte takes at most two: below 2^28)."""
    n = cols7.shape[-1]
    q, s = _on(_R7_Q, cols7.device)[:n], _on(_R7_S, cols7.device)[:n]
    t = torch.zeros(cols7.shape[:-1] + (T_COLS,), dtype=torch.int64, device=cols7.device)
    return t.index_add_(-1, q, cols7 << s)


def _reduce8(t: torch.Tensor) -> torch.Tensor:
    """Byte columns of T = a * b (< 2^768, each below 2^30) -> the canonical
    T * 2^-384 mod p as (..., 24) 16-bit limbs: the 48 byte rounds and the
    conditional subtraction.

    Round i takes the digit m_i = t_i (-p^-1) mod 2^8, which clears byte i
    of T + m_i p 2^(8i), and carries the column up. The digits depend only
    on T mod 2^384 and on the digits before them, and M = sum_i m_i 2^(8i)
    is the one value below 2^384 with T + M p = 0 mod 2^384: M = (T mod
    2^384)(-p^-1) mod 2^384. So the plain version takes the 48 digits
    together, as one exact product (as csrc/fp_mma.h does on the tensor
    cores), then (T + M p) / 2^384 < 2p, parallel carry rounds, a
    carry lookahead and one conditional subtraction (ops/fq.py). Byte pairs
    make 16-bit limbs below 2^37, so every column sum stays below 2^43."""
    limbs = fq._rounds(t[..., 0::2] + (t[..., 1::2] << 8), 1)[..., : 2 * fq.LIMBS]
    m = fq._rounds(fq._const_product(limbs[..., : fq.LIMBS], _N_PRIME, fq.LIMBS), 3)
    u, _ = fq._carry(fq._rounds(limbs + fq._const_product(m, fq.P_INT, 2 * fq.LIMBS), 3))
    return fq._reduce_once(u[..., fq.LIMBS :], torch.zeros_like(u[..., 0]))


def mont7r_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-384 mod p on (..., 24) Montgomery limbs: the 7-bit digit
    columns of one batched matmul, regrouped to bytes, 48 byte rounds of
    reduction. Equal to ``fq.mul`` bit for bit. Batches above CHUNK rows
    run CHUNK rows at a time."""
    a, b = torch.broadcast_tensors(a, b)
    rows = a.reshape(-1, fq.LIMBS), b.reshape(-1, fq.LIMBS)
    out = [_reduce8(_regroup7(product_cols7r(x, y)))
           for x, y in zip(rows[0].split(CHUNK), rows[1].split(CHUNK))]
    return (out[0] if len(out) == 1 else torch.cat(out)).reshape(a.shape)


def mont7(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The 55-digit product (product_cols7) with the same reduction."""
    return _reduce8(_regroup7(product_cols7(a, b)))


def mont8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The byte outer-product contraction (product_cols8) with the same
    reduction."""
    return _reduce8(torch.constant_pad_nd(product_cols8(a, b), (0, T_COLS - COLS8)))


def _check(a: torch.Tensor, b: torch.Tensor) -> int:
    for label, t in (("a", a), ("b", b)):
        if t.dtype != torch.int32:
            raise TypeError(f"mont7r: {label} must be int32, got {t.dtype}")
        if t.dim() != 2 or t.shape[1] != 12 or t.shape[0] < 1:
            raise ValueError(f"mont7r: {label} must be (N, 12) with N >= 1, got {tuple(t.shape)}")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError("mont7r: a and b must share N and the device")
    return a.shape[0]


def mont7r_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """n independent products on the card (csrc/mont_mxu.cu, tiles of 16
    products a warp on a grid that the launcher sizes to the card's SMs,
    two blocks of 8 warps each): (N, 12) int32 Montgomery limbs (uint32 bit
    patterns), contiguous CUDA tensors -> (N, 12) int32 a * b * 2^-384 mod
    p."""
    n = _check(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"mont7r: the kernel needs CUDA tensors, got {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("mont7r: a and b must be contiguous")
    out = torch.empty_like(a)
    lib = _kernels.load("mont_mxu")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.mont_mxu_launch(a.data_ptr(), b.data_ptr(), n, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"mont_mxu kernel launch failed: CUDA error {rc}")
    with _kernels.LAUNCH_LOCK:
        launch_counts["mont_mxu"] += 1
    _obs.launch("mont_mxu")
    return out


def mont7r(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """n products of (N, 12) int32 Montgomery limbs: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if a.device.type == "cpu":
        _check(a, b)
        return fq.limbs32(mont7r_plain(fq.limbs16(a), fq.limbs16(b)))
    return mont7r_cuda(a, b)


# ---------------------------------------------------------------------------
# The routed field product of the plain versions
# ---------------------------------------------------------------------------


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The field product of the selected multiplier on (..., 24) limbs:
    ``fq.mul`` (CIOS) under "u64", ``mont7r_plain`` under "mxu"."""
    if get_multiplier() == "mxu":
        return mont7r_plain(a, b)
    return fq.mul(a, b)


def inv(a: torch.Tensor) -> torch.Tensor:
    """a^(p - 2) on the selected multiplier (``fq.inv``'s schedule)."""
    acc = a
    for bit in fq._P_MINUS_2_BITS[1:]:
        acc = mul(acc, acc)
        if bit:
            acc = mul(acc, a)
    return acc


def to_mont(a: torch.Tensor) -> torch.Tensor:
    return mul(a, fq.const(fq.R * fq.R % fq.P_INT, a.device))


def from_mont(a: torch.Tensor) -> torch.Tensor:
    return mul(a, fq.const(1, a.device))
