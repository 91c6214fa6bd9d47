"""The port imports neither jax nor the reference package, nor the TPU probes,
nor the packages the card's machine lacks (ml_dtypes, safetensors,
transformers, tokenizers, regex).

The source is scanned rather than sys.modules: the test process imports
both packages, and an interpreter here may import jax at start-up."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = (sorted((ROOT / "krasis_tpu_torch").rglob("*.py")) + sorted((ROOT / "tools").glob("*.py"))
         + [ROOT / "chip_smoke.py"])
FORBIDDEN = ("jax", "jaxlib", "krasis_tpu", "benchmarks", "ml_dtypes", "safetensors",
             "transformers", "tokenizers", "regex")


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "krasis_tpu_torch/models/model.py" in names
    assert {"krasis_tpu_torch/perplexity.py", "krasis_tpu_torch/ops/expert_class.py",
            "krasis_tpu_torch/ops/gmm_cuda.py", "krasis_tpu_torch/ops/moe_cuda.py",
            "krasis_tpu_torch/ops/probes_cuda.py", "krasis_tpu_torch/probes/_timing.py",
            "krasis_tpu_torch/probes/probe_gmm_terms.py", "krasis_tpu_torch/timing.py"} <= names
    assert {"krasis_tpu_torch/models/loader.py", "krasis_tpu_torch/models/weight_cache.py",
            "krasis_tpu_torch/utils/safetensors_io.py", "krasis_tpu_torch/utils/gguf.py",
            "krasis_tpu_torch/utils/gguf_source.py"} <= names
    assert {"krasis_tpu_torch/runtime/tokenizer.py", "krasis_tpu_torch/runtime/chat_template.py",
            "krasis_tpu_torch/utils/unicode_re.py", "krasis_tpu_torch/server.py",
            "krasis_tpu_torch/chat.py", "krasis_tpu_torch/native/__init__.py",
            "krasis_tpu_torch/native/serve.py", "krasis_tpu_torch/runtime/scheduler.py"} <= names
    assert {"krasis_tpu_torch/prompts.py", "krasis_tpu_torch/benchmark.py",
            "krasis_tpu_torch/quality.py", "krasis_tpu_torch/runtime/bpe_train.py",
            "krasis_tpu_torch/models/train_qwen3moe.py"} <= names
    assert {"chip_smoke.py", "tools/sass_compare.py", "tools/measure_phases.py"} <= names
    assert {"krasis_tpu_torch/parallel/mesh.py", "krasis_tpu_torch/parallel/ep.py",
            "krasis_tpu_torch/parallel/pp.py", "krasis_tpu_torch/parallel/sp.py",
            "tools/mesh_phases.py"} <= names
    assert {f"krasis_tpu_torch/{m}.py" for m in (
        "syscheck", "runlog", "tracing", "cli", "stress_test", "suite", "fused_moe",
        "auto_optimise", "debug_tokenizer", "launcher", "launcher_tui")} | {
        "tools/tooling_phases.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for mod in _imported(tree):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"
