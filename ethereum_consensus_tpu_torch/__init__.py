"""ethereum_consensus_tpu_torch — the beacon-chain consensus framework on
PyTorch and CUDA.

The port of ``ethereum_consensus_tpu`` (JAX on a TPU) to an NVIDIA H100.
Spec logic stays host Python with exact u64 semantics; the device hot
paths are CUDA C++ kernels written for Hopper (``sm_90a``), built from
``csrc/`` on first use and bound with ctypes.

Layout (each module sits at the same relative path as its reference):
  ssz/       SSZ type algebra, codec, merkleization
  config/    presets, network configs, Context
  models/    phase0 containers and slot processing
  native/    host C++ SHA-256 merkle backend
  ops/       CUDA SHA-256 kernel wrapper and device merkle reduction
  csrc/      CUDA sources
  convert.py state and word-tensor carry-across helpers
"""

__version__ = "0.1.0"

from . import error, fork, primitives, ssz  # noqa: F401
from .fork import Fork  # noqa: F401
