"""Device kernels (CUDA C++ for Hopper): SHA-256 merkleization, the
committee shuffle, G1 pubkey-set aggregation, the effective-balance
hysteresis sweep, the altair sweeps (flag deltas, inactivity updates and
penalties), the fused altair epoch kernel and the batched pairing of RLC
signature verification.

Importing this package imports torch but builds nothing; the pure-host
layers (ssz/, models/, crypto/) never import it at module level — device
acceleration is installed explicitly via ``install()``.
"""

from .. import _device_flags, _env
from ..ssz.hash import register_device_hasher
from .merkle import merkleize_chunks_device
from .sha256 import install_device_hasher, sha256_64b, sha256_64b_plain

# The reference's thresholds. Its sweeps crossover (2^17) was measured on
# a TPU; the crossover on this card has not been measured.
DEFAULT_SWEEPS_MIN_N = 1 << 17
DEFAULT_SHUFFLE_MIN_N = 1 << 15
DEFAULT_BLS_AGG_MIN_N = 1 << 12
# The reference's auto threshold for the device RLC batch: block-sized
# batches (66 or 67 sets) keep the native multi-pairing, and the windowed
# flushes of a range sync (8 blocks, 528 sets) reach the card. Set from
# ECT_PAIRING_MIN_SETS: a count, or off/none/host for the host engine (the
# reference's parse, except that an unparsable value raises instead of
# giving 512).
DEFAULT_PAIRING_MIN_SETS = _env.min_count("ECT_PAIRING_MIN_SETS", 512)


def install(
    device="cuda",
    sweeps_min_n: int = DEFAULT_SWEEPS_MIN_N,
    shuffle_min_n: int = DEFAULT_SHUFFLE_MIN_N,
    bls_agg_min_n: int = DEFAULT_BLS_AGG_MIN_N,
    pairing_min_sets: "int | None" = DEFAULT_PAIRING_MIN_SETS,
) -> None:
    """Route the spec path's device work to the kernels on ``device``:

    * SHA-256 hash levels of at least ssz.hash.DEVICE_MIN_NODES parent
      nodes (merkleization);
    * the epoch boundary's registry sweeps of registries of at least
      ``sweeps_min_n`` validators: for altair states the columnar engine
      runs inactivity and rewards as one launch of the fused epoch kernel,
      and the literal stages (engine off) run the flag-delta, inactivity
      and hysteresis kernels; phase0 takes the literal stages with the
      hysteresis kernel;
    * whole-list committee shuffling of at least ``shuffle_min_n`` indices;
    * G1 pubkey aggregation (fast_aggregate_verify, batched signature
      sets) of at least ``bls_agg_min_n`` keys in all;
    * the RLC batch verification of at least ``pairing_min_sets``
      signature sets (None keeps every batch on the host): the blinder
      multiplications, the Miller loops and their product on the card,
      the final exponentiation in the native library.

    Spec semantics are unchanged — every kernel is bit-identical to its
    host function; the thresholds only decide where the work runs. With
    ``device="cuda"`` and no card this raises; ``device="cpu"`` routes to
    the kernels' plain versions (the tests' configuration)."""
    install_device_hasher(device=device)
    _device_flags.DEVICE = str(device)
    _device_flags.SWEEPS_MIN_N = sweeps_min_n
    _device_flags.SHUFFLE_MIN_N = shuffle_min_n
    _device_flags.BLS_AGG_MIN_N = bls_agg_min_n
    _device_flags.PAIRING_MIN_SETS = pairing_min_sets


def uninstall() -> None:
    """Send every hash level, sweep, shuffle, aggregation and pairing back
    to the host."""
    register_device_hasher(None)
    _device_flags.SWEEPS_MIN_N = None
    _device_flags.SHUFFLE_MIN_N = None
    _device_flags.BLS_AGG_MIN_N = None
    _device_flags.PAIRING_MIN_SETS = None
    _device_flags.DEVICE = "cuda"
    from ..models.phase0 import helpers as _phase0_helpers

    _phase0_helpers._SHUFFLE_CACHE.clear()


__all__ = [
    "DEFAULT_BLS_AGG_MIN_N",
    "DEFAULT_PAIRING_MIN_SETS",
    "DEFAULT_SHUFFLE_MIN_N",
    "DEFAULT_SWEEPS_MIN_N",
    "install",
    "install_device_hasher",
    "merkleize_chunks_device",
    "sha256_64b",
    "sha256_64b_plain",
    "uninstall",
]
