"""ethereum_consensus_tpu_torch — the beacon-chain consensus framework on
PyTorch and CUDA.

The port of ``ethereum_consensus_tpu`` (JAX on a TPU) to an NVIDIA H100.
Spec logic stays host Python with exact u64 semantics; the device hot
paths are CUDA C++ kernels written for Hopper (``sm_90a``), built from
``csrc/`` on first use and bound with ctypes.

Layout (each module sits at the same relative path as its reference):
  ssz/        SSZ type algebra, codec, merkleization
  config/     presets, network configs, Context
  crypto/     BLS12-381 signatures (pure-Python oracle + native backend)
  models/     phase0 and altair containers, helpers, slot, block and
              epoch processing, the state transitions and the altair
              upgrade, the columnar epoch engine and the committee masks
  native/     host C++ SHA-256 merkle and BLS12-381 backends
  ops/        CUDA kernel wrappers: SHA-256 and the device merkle
              reduction, the committee shuffle, G1 pubkey-set sums,
              the epoch sweeps (hysteresis, altair flag deltas and
              inactivity) and the fused altair epoch kernel
  csrc/       CUDA sources
  executor.py block application with the phase0 -> altair upgrade
  convert.py  state and word-tensor carry-across helpers
"""

__version__ = "0.1.0"

from . import error, fork, primitives, ssz  # noqa: F401
from .fork import Fork  # noqa: F401
