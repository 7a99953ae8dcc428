"""``import_from_torch.py``, on the CPU: a checkpoint of the port's train
CLI (a seeded model at test size, two scored steps, the best the older)
goes through the importer in a process of its own into a reference stage
directory.  The reference's ``CheckpointManager.restore_params(best=
True)`` then gives the port's parameters back bit for bit through
``weights.from_flax``; the reference's greedy decode on them gives the
port's tokens; the reference's ``eval.py`` rebuilds the model from the
written ``infos.json``, which carries the stage's options; and a second
import into the same directory is refused.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.data import synthetic as jsynthetic
from cst_captioning_tpu.data.dataset import CaptionDataset as JaxDataset
from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu.opts import parse_opts
from cst_captioning_tpu.ops.sampling import greedy_decode as jax_greedy
from cst_captioning_tpu.training.checkpoint import (
    CheckpointManager as JaxCheckpointManager)
from cst_captioning_tpu.training.state import (create_train_state,
                                               make_optimizer)
from cst_captioning_tpu_torch.models import CaptionModel
from cst_captioning_tpu_torch.ops.sampling import greedy_decode
from cst_captioning_tpu_torch.training.checkpoint import CheckpointManager
from cst_captioning_tpu_torch.weights import from_flax, init_random_

REPO = Path(__file__).resolve().parent.parent
SPEC = dict(num_videos=6, captions_per_video=3, max_len=8, feat_dims=(8, 5),
            feat_times=(3, 1), seed=0)
FEAT_SHAPES = [(3, 8), (1, 5)]
#: The options the port's train CLI saves, with some the reference does
#: not have (they stay out of the imported ``opt``).
PORT_OPT = {"rnn_size": 16, "input_encoding_size": 16, "att_size": 16,
            "max_length": 8, "use_bfloat16": 0, "model_type": "lstm",
            "learning_rate": 2e-5, "use_rl": 1, "rl_baseline": "scb-sample",
            "decode_kernel": "fused", "synthetic_videos": 6,
            "feat_shapes": "3x8,1x5"}


def _port_model(vocab_size, seed):
    model = CaptionModel(vocab_size=vocab_size, feat_dims=(8, 5),
                         embed_size=16, hidden_size=16, attn_size=16,
                         drop_prob=0.0)
    return init_random_(model, seed).eval()


def _run_importer(src, dst, home):
    return subprocess.run(
        [sys.executable, str(REPO / "import_from_torch.py"),
         "--checkpoint_path", str(src), "--out_dir", str(dst)],
        capture_output=True, text=True, timeout=240, cwd=REPO,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
             "HOME": str(home)})


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    root = tmp_path_factory.mktemp("import")
    paths = jsynthetic.generate(str(root), "val",
                                jsynthetic.SyntheticSpec(**SPEC))
    split = jsynthetic.split_paths(paths)
    with JaxDataset(split) as ds:
        vocab_size = ds.vocab.size_with_pad
    best, later = _port_model(vocab_size, 7), _port_model(vocab_size, 8)
    mgr = CheckpointManager(str(root / "port"), max_to_keep=2)
    for step, model, score in ((16, best, 2.0), (32, later, 1.0)):
        mgr.save(step, {"model": model.state_dict()}, score,
                 extra={"opt": PORT_OPT})
    proc = _run_importer(root / "port", root / "ref", root)
    assert proc.returncode == 0, proc.stderr[-2000:]
    jm = JaxCaptionModel(vocab_size=vocab_size, embed_size=16,
                         hidden_size=16, attn_size=16, dropout_rate=0.0)
    target = create_train_state(jm, jax.random.PRNGKey(0), FEAT_SHAPES, 8,
                                1, make_optimizer()[0]).params
    ref = JaxCheckpointManager(str(root / "ref"), readonly=True)
    restored = ref.restore_params(target, best=True)
    ref.close()
    return {"root": root, "split": split, "model": best, "jm": jm,
            "restored": jax.tree_util.tree_map(np.asarray, restored),
            "stdout": json.loads(proc.stdout.strip().splitlines()[-1])}


def test_import_round_trips_the_parameters_bit_for_bit(imported):
    leaves = jax.tree_util.tree_leaves(imported["restored"])
    assert leaves and all(x.dtype == np.float32 for x in leaves)
    back = from_flax(imported["restored"])
    want = imported["model"].state_dict()
    assert set(back) == set(want)
    for key, value in want.items():
        assert torch.equal(back[key], value), key


def test_reference_greedy_decode_on_the_import_gives_the_port_tokens(
        imported):
    rng = np.random.default_rng(3)
    feats = [rng.normal(size=(5,) + s).astype(np.float32)
             for s in FEAT_SHAPES]
    want = greedy_decode(imported["model"],
                         [torch.from_numpy(f) for f in feats], 8).numpy()
    got = np.asarray(jax_greedy(imported["jm"],
                                {"params": imported["restored"]},
                                [jnp.asarray(f) for f in feats], 8))
    np.testing.assert_array_equal(got, want)
    assert (want > 0).any(), "the decode made no token"


def test_infos_carry_the_stage_options_and_the_reference_eval_reads_them(
        imported):
    root = imported["root"]
    infos = json.loads((root / "ref" / "infos.json").read_text())
    assert infos["best_step"] == 16 and infos["best_score"] == 2.0
    assert infos["imported_from"]["step"] == 16
    assert imported["stdout"]["best_step"] == 16
    opt = infos["opt"]
    for key in ("rnn_size", "input_encoding_size", "att_size", "max_length",
                "use_bfloat16", "model_type", "learning_rate", "use_rl",
                "rl_baseline"):
        assert opt[key] == PORT_OPT[key], key
    assert "synthetic_videos" not in opt and "feat_shapes" not in opt
    assert opt["optim"] == "adam"       # the reference's default kept
    spec = importlib.util.spec_from_file_location("reference_eval",
                                                  REPO / "eval.py")
    ref_eval = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_eval)
    with JaxDataset(imported["split"]) as ds:
        model, params, eval_opt = ref_eval.load_model_for_eval(
            str(root / "ref"), ds, parse_opts([]))
    assert (model.hidden_size, eval_opt.rnn_size, eval_opt.max_length) == (
        16, 16, 8)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(imported["restored"])):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_import_refuses_a_directory_that_holds_a_checkpoint(imported):
    root = imported["root"]
    proc = _run_importer(root / "port", root / "ref", root)
    assert proc.returncode != 0
    assert "already holds checkpoint step 16" in proc.stderr


@pytest.mark.parametrize("port_opt, want", [
    ({"use_bfloat16": 1, "rnn_size": 192}, {"use_bfloat16": 1,
                                            "rnn_size": 192}),
    ({"only_in_the_port": 3}, {"use_bfloat16": 0, "rnn_size": 512}),
])
def test_reference_opts_overlay_only_the_reference_options(port_opt, want):
    sys.path.insert(0, str(REPO))
    import import_from_torch

    opt = import_from_torch.reference_opts(port_opt)
    assert not hasattr(opt, "only_in_the_port")
    for key, value in want.items():
        assert getattr(opt, key) == value, key
