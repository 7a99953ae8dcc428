"""The port stands alone: no module of ``cst_captioning_tpu_torch`` and
not ``chip_smoke.py`` imports JAX, Flax, Optax, Orbax or the reference
package, nor anything but the standard library, numpy and torch (the
card's machine has no ``h5py``, for one); and no entry point runs on the
CPU unless the caller asks for it.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cst_captioning_tpu_torch as port
from cst_captioning_tpu_torch import serve
from cst_captioning_tpu_torch.models import CaptionModel
from cst_captioning_tpu_torch.weights import model_from_flax

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "cst_captioning_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "cst_captioning_tpu")
ALLOWED = frozenset(sys.stdlib_module_names) | {"numpy", "torch",
                                                PKG.name}


def _sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    """Absolute names of every module ``path`` imports (relative imports
    resolved against its package)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    rel = path.relative_to(REPO).with_suffix("")
    package = list(rel.parts[:-1])
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[:len(package) - node.level + 1]
                assert len(base) >= 1 and base[0] == PKG.name, (
                    f"{path}: relative import leaves the package")
                yield ".".join(base + ([node.module] if node.module else []))
            else:
                yield node.module


def test_sources_found():
    names = {p.name for p in _sources()}
    assert {"chip_smoke.py", "engine.py", "decode_cell_kernel.py",
            "attention_kernel.py", "serve.py", "train.py", "trainer.py",
            "synthetic.py", "ciderd.py", "eval.py", "coco_eval.py",
            "bleu.py", "meteor.py", "rouge.py", "exitcodes.py", "faults.py",
            "integrity.py", "preemption.py", "watchdog.py", "registry.py",
            "checkpoint.py", "bench.py", "flops.py", "loader.py",
            "rewards.py", "tokenizer.py", "dataset.py", "prepro.py",
            "converters.py", "consensus.py", "device_rewards.py",
            "weights.py", "stage_chain.py", "journal.py", "supervisor.py",
            "autoscale.py", "fleetobs.py", "serve_supervisor.py"} <= names
    # The on-disk data path, the port's own copies.
    assert {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")} >= {
        "data/dataset.py", "data/prepro.py", "data/converters.py",
        "data/synthetic.py", "metrics/ciderd.py", "metrics/consensus.py"}
    native = PKG / "native"
    assert {"__init__.py", "ciderd.cpp", "tokenizer.cpp"} <= {
        p.name for p in native.iterdir()}
    # Both bench modules, the port's own, beside the top-level one.
    assert {p.relative_to(PKG).as_posix() for p in _sources()
            if p.name == "bench.py"} >= {"bench.py", "data/bench.py",
                                         "serving/bench.py"}


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(REPO)))
def test_no_reference_or_jax_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(REPO)))
def test_no_exporter_or_h5py_imports(path):
    """The exporter (``export_for_torch.py``, JAX and ``h5py``) runs where
    the reference's files are; the port only reads what it writes."""
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("export_for_torch", "h5py"), f"{path} imports {mod}"
    assert "import export_for_torch" not in path.read_text()


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(REPO)))
def test_imports_only_stdlib_numpy_torch(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top in ALLOWED, f"{path} imports {mod}"


def test_fresh_import_loads_no_jax():
    """Importing every module of the port in a fresh interpreter leaves
    JAX and the reference package out of ``sys.modules``."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        .removesuffix(".__init__") for p in PKG.rglob("*.py"))
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
            + repr(FORBIDDEN) + "]\nprint(bad)\nassert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_bf16_products_reduce_in_float32():
    """A bfloat16 product is a float32 sum rounded once, as XLA computes
    it: cuBLAS may not reduce split-K partial sums in bfloat16."""
    assert (torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
            is False)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(REPO)))
def test_no_autocast(path):
    """bfloat16 compute is explicit casts in each module, never
    ``torch.autocast`` (which keeps softmax, log-softmax and the losses in
    float32 and picks its own cast points): no name or attribute
    ``autocast`` appears in the code (docstrings may say so)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        name = (node.attr if isinstance(node, ast.Attribute) else
                node.id if isinstance(node, ast.Name) else
                " ".join(a.name for a in node.names)
                if isinstance(node, (ast.Import, ast.ImportFrom)) else "")
        assert "autocast" not in name, f"{path}:{node.lineno} uses {name}"


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.default_device("cuda")
    assert port.default_device("cpu") == torch.device("cpu")


def test_model_from_flax_raises_without_gpu_unless_cpu(no_gpu):
    model = CaptionModel(10, [4], embed_size=8, hidden_size=8, attn_size=8)
    params = {
        "encoder": {"embed_0": {"kernel": np.zeros((4, 8), np.float32),
                                "bias": np.zeros(8, np.float32)},
                    "fuse": {"kernel": np.zeros((8, 8), np.float32),
                             "bias": np.zeros(8, np.float32)}},
        "memory_proj": {"kernel": np.zeros((8, 8), np.float32)},
        "cell": {"embed": {"embedding": np.zeros((10, 8), np.float32)},
                 "attn": {"query_proj": {"kernel": np.zeros((8, 8),
                                                            np.float32)},
                          "score_v": np.zeros(8, np.float32)},
                 "lstm0": {
                     **{f"i{g}": {"kernel": np.zeros((16, 8), np.float32)}
                        for g in "ifgo"},
                     **{f"h{g}": {"kernel": np.zeros((8, 8), np.float32),
                                  "bias": np.zeros(8, np.float32)}
                        for g in "ifgo"}}},
        "state_init_0": {"kernel": np.zeros((8, 16), np.float32),
                         "bias": np.zeros(16, np.float32)},
        "logit": {"kernel": np.zeros((8, 10), np.float32),
                  "bias": np.zeros(10, np.float32)},
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_from_flax(params)
    cpu = model_from_flax(params, device="cpu")
    assert cpu.device == torch.device("cpu")
    assert set(cpu.state_dict()) == set(model.state_dict())


def test_serve_cli_raises_without_gpu_unless_cpu(no_gpu):
    argv = ["--serve_demo", "1", "--rnn_size", "8",
            "--input_encoding_size", "8", "--att_size", "8",
            "--vocab_size", "10", "--feat_shapes", "2x4"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_backend(serve.parse_args(argv))
    model, vocab, shapes, feats_for = serve.build_backend(
        serve.parse_args(argv + ["--device", "cpu"]))
    assert model.device == torch.device("cpu") and shapes == [(2, 4)]
    assert len(vocab) == 9 and feats_for("v3")[0].shape == (2, 4)
    assert feats_for("v99") is None and feats_for("x") is None


#: The process fleet's supervisor side: host code that never touches the
#: card (only the serve-CLI children do).
SUPERVISOR_MODULES = ("serving/supervisor.py", "serving/journal.py",
                      "serving/autoscale.py", "telemetry/fleetobs.py")


@pytest.mark.parametrize("rel", SUPERVISOR_MODULES)
def test_supervisor_modules_import_no_torch(rel):
    mods = set(_imported_modules(PKG / rel))
    assert not {m for m in mods if m.split(".")[0] in ("torch", "numpy")}
    assert not {m for m in mods if m.startswith(f"{PKG.name}.ops")}


def test_supervisor_children_keep_the_device_choice(tmp_path):
    """A child gets ``--device`` only when the supervisor was given one: a
    child on a machine without a GPU raises, never falls back."""
    from cst_captioning_tpu_torch import serve_supervisor as ss

    base = ["--serve_demo", "1", "--supervise_replicas", "2"]
    opt = ss.parse_supervisor_args(base)
    argv = ss.child_argv(opt, str(tmp_path), 0)
    assert argv[1:3] == ["-m", "cst_captioning_tpu_torch.serve"]
    assert "--device" not in argv
    assert "--supervise_replicas" not in argv      # never raw argv
    cpu = ss.child_argv(ss.parse_supervisor_args(base + ["--device", "cpu"]),
                        str(tmp_path), 0)
    assert cpu[cpu.index("--device") + 1] == "cpu"
