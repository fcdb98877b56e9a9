"""The port stands alone: no module of `src/repro_torch/`, no example of
the port (`examples/torch_*.py`) and no part of `chip_smoke.py` imports
JAX, the JAX package `repro` or the reference's `benchmarks` (only the
tests import both).  Checked on the syntax tree, so an import inside a function
counts as much as one at the top."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
    (ROOT / "examples").glob("torch_*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_the_port_has_its_files():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "chip_smoke.py" in names
    assert "src/repro_torch/serve/service.py" in names
    assert {"src/repro_torch/prng.py", "src/repro_torch/core/sgd.py",
            "src/repro_torch/data/synthetic.py",
            "src/repro_torch/kernels/mf_sgd/kernel.py",
            "src/repro_torch/train/trainer.py",
            "src/repro_torch/train/checkpoint.py",
            "src/repro_torch/resil/faults.py",
            "src/repro_torch/kernels/simlsh_encode/kernel.py",
            "src/repro_torch/kernels/simlsh_encode/ops.py",
            "src/repro_torch/kernels/neighbor_predict/kernel.py",
            "src/repro_torch/kernels/neighbor_predict/ops.py",
            "src/repro_torch/core/scatter.py",
            "src/repro_torch/resil/rebuild.py",
            "src/repro_torch/resil/wal.py",
            "src/repro_torch/loop/supervisor.py",
            "src/repro_torch/core/gsm.py",
            "src/repro_torch/core/baselines.py",
            "src/repro_torch/core/ncf.py",
            "src/repro_torch/configs/base.py",
            "src/repro_torch/configs/all.py",
            "src/repro_torch/configs/llama3_8b.py",
            "src/repro_torch/models/layers.py",
            "src/repro_torch/models/lm.py",
            "src/repro_torch/models/steps.py",
            "src/repro_torch/models/ssm.py",
            "src/repro_torch/models/moe.py",
            "src/repro_torch/launch/serve.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/launch/specs.py",
            "src/repro_torch/launch/roofline.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/models/sharding.py",
            "src/repro_torch/models/lsh_softmax.py",
            "src/repro_torch/tree.py",
            "examples/torch_quickstart.py",
            "examples/torch_online_learning.py",
            "examples/torch_serve_recsys.py",
            "examples/torch_train_lshmf_100m.py",
            "examples/torch_train_lm.py"} <= names
    configs = {p.stem for p in (ROOT / "src" / "repro" / "configs").glob(
        "*.py")}
    assert {f"src/repro_torch/configs/{c}.py" for c in configs} <= names
    assert len(names) >= 20


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(
    ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_the_scan_sees_nested_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("def g():\n    from repro.obs import get\n"
                 "    import jax.numpy\n    return __import__('repro')\n")
    assert {"repro", "jax"} <= _imported_roots(f)
