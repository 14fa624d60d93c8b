"""Package boundary of the PyTorch port: it never imports jax or the JAX
package, and its entry point defaults to the CUDA card."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

PKG = pathlib.Path(__file__).resolve().parents[1] / "myscaledb_tpu_torch"
ROOT = PKG.parent


def test_import_loads_no_jax():
    code = ("import sys, myscaledb_tpu_torch\n"
            "import myscaledb_tpu_torch.sql.driver, "
            "myscaledb_tpu_torch.interop, myscaledb_tpu_torch.ops.join, "
            "myscaledb_tpu_torch.ops.binary_vector, "
            "myscaledb_tpu_torch.ops.kernels.merge_count, "
            "myscaledb_tpu_torch.ops.kernels.binary_scan, "
            "myscaledb_tpu_torch.storage.table_store, "
            "myscaledb_tpu_torch.storage.skip_index, "
            "myscaledb_tpu_torch.storage.codecs, "
            "myscaledb_tpu_torch.runtime.faults, "
            "myscaledb_tpu_torch.runtime.dictionaries, "
            "myscaledb_tpu_torch.sql.plan\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'myscaledb_tpu' "
            "or m.startswith('myscaledb_tpu.')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_imports_in_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "myscaledb_tpu"), \
            f"{path.name} imports {mod}"


def test_chip_smoke_imports_no_jax():
    mods = set(_imported_modules(ROOT / "chip_smoke.py"))
    assert not any(m.split(".")[0] in ("jax", "myscaledb_tpu") for m in mods)


def test_connect_defaults_to_cuda(monkeypatch):
    import myscaledb_tpu_torch as P
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        P.connect()
    s = P.connect(device="cpu")
    assert s.device == torch.device("cpu")
    t = s.create_table("t", {"a": [1, 2, 3]})
    assert t["a"].data.device == torch.device("cpu")


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors; any other
    device launches the kernel (CUDA) or raises — it never falls back."""
    from myscaledb_tpu_torch.ops.kernels.binary_scan import (
        SEG, binary_segment_mins)
    from myscaledb_tpu_torch.ops.kernels.merge_count import merge_count
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        merge_count(torch.zeros(4, dtype=torch.int32, device=meta),
                    torch.zeros(8, dtype=torch.int32, device=meta),
                    torch.zeros((), dtype=torch.bool, device=meta))
    x3 = torch.zeros((16, 2, SEG), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        binary_segment_mins(x3, torch.zeros((1, 2), dtype=torch.int32,
                                            device=meta),
                            torch.zeros((16, SEG), dtype=torch.uint8,
                                        device=meta), "Hamming", 100, False)
