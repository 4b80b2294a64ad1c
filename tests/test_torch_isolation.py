"""The port stands alone: no jax, nothing of the reference package, and its
CUDA entry points fail loudly on a machine without a card."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ethereum_consensus_tpu_torch import ops
from ethereum_consensus_tpu_torch.ssz import hash as port_hash
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "ethereum_consensus_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "ethereum_consensus_tpu"}


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_module_imports_neither_jax_nor_the_reference(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, ethereum_consensus_tpu_torch, ethereum_consensus_tpu_torch.ops, "
        "ethereum_consensus_tpu_torch.convert, ethereum_consensus_tpu_torch.models, "
        "ethereum_consensus_tpu_torch.ops.fq, ethereum_consensus_tpu_torch.ops.fq2, "
        "ethereum_consensus_tpu_torch.ops.fq12, ethereum_consensus_tpu_torch.ops.pairing, "
        "ethereum_consensus_tpu_torch.executor, ethereum_consensus_tpu_torch.execution_engine, "
        "ethereum_consensus_tpu_torch.models.bellatrix, ethereum_consensus_tpu_torch.models.capella, "
        "ethereum_consensus_tpu_torch.models.deneb, ethereum_consensus_tpu_torch.crypto.kzg; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r}]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port_hash, "_device_hasher", None)


def test_install_without_a_card_raises(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.install()
    assert port_hash._device_hasher is None


def test_device_merkleizer_without_a_card_raises(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.merkleize_chunks_device(b"\x00" * 64)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
