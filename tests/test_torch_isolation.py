"""nano_tpu_torch stands alone: it never imports jax or nano_tpu, and its
entry points run on CUDA unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import nano_tpu_torch
from nano_tpu_torch.config import ModelConfig
from nano_tpu_torch.infer import engine
from nano_tpu_torch.io.from_jax import params_from_jax
from nano_tpu_torch.train import __main__ as train_main
from nano_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "js", "fixtures")


def _sources():
    pkg = os.path.join(ROOT, "nano_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_modules(path):
    """Every module an import statement in `path` names, at any depth."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_names_jax_or_nano_tpu():
    for path in _sources():
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "nano_tpu"), (path, mod)


def _imports_by_scope(path):
    """(module, the dotted names of the classes and functions around the
    import statement, "" at module level) for every import in `path`."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())

    def walk(node, scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                for a in child.names:
                    yield a.name, scope
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child.module, scope
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                    ast.ClassDef)):
                yield from walk(child, f"{scope}.{child.name}".lstrip("."))
            else:
                yield from walk(child, scope)
    yield from walk(tree, "")


# the optional backends that are transformers itself, imported inside the
# function that runs them and nowhere else: the gateway's HF backend and
# the HF speech recognizer (the JAX package's counterparts do the same)
TRANSFORMERS_BACKENDS = {
    ("nano_tpu_torch/serve/gateway.py", "HFGateway.__init__"),
    ("nano_tpu_torch/serve/gateway.py", "HFGateway._generate_stream"),
    ("nano_tpu_torch/serve/asr.py", "make_transformers_recognizer"),
}


def test_no_source_names_safetensors_or_transformers():
    """The port needs neither package: it reads safetensors files by hand,
    and no code path but the transformers backends (inside their
    functions, TRANSFORMERS_BACKENDS) names transformers."""
    seen = set()
    for path in _sources():
        rel = os.path.relpath(path, ROOT).replace(os.sep, "/")
        for mod, scope in _imports_by_scope(path):
            top = mod.split(".")[0]
            assert top != "safetensors", (path, mod)
            if top == "transformers":
                assert (rel, scope) in TRANSFORMERS_BACKENDS, (path, scope)
                seen.add((rel, scope))
    assert seen == TRANSFORMERS_BACKENDS


def test_importing_everything_loads_no_jax():
    mods = sorted({m for p in _sources() for m in _imported_modules(p)
                   if m.split(".")[0] in ("nano_tpu_torch", "torch", "numpy")})
    pkg_mods = []
    for path in _sources():
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        pkg_mods.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                        else rel)
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {sorted(set(mods + pkg_mods))!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'nano_tpu', 'safetensors', 'transformers')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        nano_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.LLMContext.from_bin(os.path.join(FIX, "tiny_f32.bin"))
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.LLMContext(cfg=ModelConfig(), params={}, tokenizer=None,
                          max_seq_len=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"norm": [1.0, 2.0]})
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(ModelConfig(), {})
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.LLMContext.from_checkpoint("unread.npz")
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.LLMContext.from_gguf("unread.gguf")
    # asking for the CPU is the only way onto it
    assert Trainer(ModelConfig(), {}, device="cpu").device.type == "cpu"
    ctx = engine.LLMContext.from_bin(os.path.join(FIX, "tiny_f32.bin"),
                                     device="cpu")
    assert ctx.device.type == "cpu"
    assert ctx.params["norm"].device.type == "cpu"


def test_new_modules_are_among_the_checked_sources():
    """The walk above covers the training slice's modules, the serving
    package and its frontends too."""
    rel = {os.path.relpath(p, ROOT) for p in _sources()}
    for mod in ("data/preprocess.py", "train/data.py", "train/trainer.py",
                "train/__main__.py", "io/checkpoint.py", "ops/flash_attn.py",
                "ops/launches.py", "serve/__init__.py", "serve/batching.py",
                "infer/speculative.py", "export.py", "io/gguf.py",
                "io/qwen.py", "io/pt_import.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/launch.py", "observe.py",
                "serve/cli.py", "serve/wss.py", "serve/openai_http.py",
                "serve/gateway.py", "serve/asr.py", "serve/voice_ws.py",
                "infer/__main__.py"):
        assert os.path.join("nano_tpu_torch", mod) in rel


def test_rank_functions_of_the_parallel_tests_import_no_jax():
    """The spawned ranks of tests/test_torch_parallel.py and
    tests/test_torch_infer_tp*.py import tests/torch_parallel_ranks.py by
    name: it, and what it imports, must load no jax."""
    path = os.path.join(ROOT, "tests", "torch_parallel_ranks.py")
    for mod in _imported_modules(path):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "nano_tpu"), mod
    code = ("import sys\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "import tests.torch_parallel_ranks\n"
            "import nano_tpu_torch.parallel.launch\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'nano_tpu')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def test_train_entry_point_defaults_to_cuda(monkeypatch, tmp_path):
    import json
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mc, tc = str(tmp_path / "m.json"), str(tmp_path / "t.json")
    for path in (mc, tc):
        with open(path, "w") as f:
            json.dump({}, f)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main.main(["-m", mc, "-t", tc, "--max_steps", "1"])
