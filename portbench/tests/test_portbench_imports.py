"""Nothing under portbench/ imports JAX or the JAX package, comparing
top-level names whole; the reference imports nothing of the program."""

from pathlib import Path

from portbench import guard

HERE = Path(__file__).resolve().parents[1]


def test_top_level_names_compared_whole():
    assert guard.top("myscaledb_tpu_torch.sql.driver") == \
        "myscaledb_tpu_torch"
    assert guard.loaded_forbidden(["myscaledb_tpu_torch",
                                   "myscaledb_tpu_torch.ops",
                                   "jaxtyping", "flaxen"]) == []
    assert guard.loaded_forbidden(["myscaledb_tpu.ops", "jax.numpy",
                                   "jaxlib", "flax.linen"]) == \
        ["flax.linen", "jax.numpy", "jaxlib", "myscaledb_tpu.ops"]


def test_no_file_imports_the_jax_side():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        tops = {guard.top(n) for n in guard.imported_names(f)}
        assert not tops & guard.FORBIDDEN, f


def test_reference_imports_nothing_of_the_program():
    refs = sorted((HERE / "reference").glob("*.py"))
    assert refs
    for f in refs:
        tops = {guard.top(n) for n in guard.imported_names(f)}
        assert guard.PROGRAM not in tops, f
        assert not any(n.startswith(".") for n in guard.imported_names(f))
    for f in sorted((HERE / "datagen").glob("*.py")):
        assert guard.PROGRAM not in {guard.top(n)
                                     for n in guard.imported_names(f)}, f


def test_the_import_scan_sees_every_form(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom myscaledb_tpu.ops import x\n"
                 "import importlib\nimportlib.import_module('flax')\n")
    assert {guard.top(n) for n in guard.imported_names(f)} == \
        {"jax", "myscaledb_tpu", "importlib", "flax"}
