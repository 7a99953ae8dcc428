"""``tools/stage_chain.py``'s starts, on the CPU: XE and WXE started
from a given directory (``--xe_start_from``, ``--wxe_start_from``) and
the ``init`` stage, which writes the train CLI's initialization at
``--seed`` as step 0 of a train-CLI directory.  The train CLI's XE from
that directory ends bit for bit where its XE from scratch at the same
seed ends; the reference's ``import_from_torch.py`` reads it, and the
reference's ``restore_params(best=True)`` gives the tree back bit for bit
through ``weights.from_flax``.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu.training.checkpoint import (
    CheckpointManager as JaxCheckpointManager)
from cst_captioning_tpu.training.state import (create_train_state,
                                               make_optimizer)
from cst_captioning_tpu_torch import train
from cst_captioning_tpu_torch.tools import stage_chain
from cst_captioning_tpu_torch.training import checkpoint
from cst_captioning_tpu_torch.weights import from_flax

REPO = Path(__file__).resolve().parent.parent
#: A train-CLI spec at test size: 8 videos, an epoch of 4 steps.
TINY = ["--synthetic_videos", "8", "--synthetic_val_videos", "4",
        "--captions_per_video", "3", "--feat_shapes", "2x6,1x5",
        "--rnn_size", "8", "--input_encoding_size", "8", "--att_size", "8",
        "--batch_size", "2", "--seq_per_img", "3", "--max_length", "6",
        "--max_epochs", "1", "--fast_val", "1", "--log_every", "1",
        "--device", "cpu", "--seed", "5"]


def _flag(argv, name):
    return argv[argv.index(name) + 1] if name in argv else None


def _without_start(argv):
    if "--start_from" not in argv:
        return argv
    i = argv.index("--start_from")
    return argv[:i] + argv[i + 2:]


def test_xe_and_wxe_start_where_they_are_told():
    plain = stage_chain.stage_argv("out")
    assert _flag(plain["xe"], "--start_from") is None
    assert _flag(plain["wxe"], "--start_from") == "out/checkpoints/xe"
    assert _flag(plain["cst"], "--start_from") == "out/checkpoints/wxe"
    started = stage_chain.stage_argv("out", xe_start_from="i/init",
                                     wxe_start_from="ref/xe",
                                     start_from="ref/wxe", seed=3)
    for name, start in (("xe", "i/init"), ("wxe", "ref/xe"),
                        ("cst", "ref/wxe")):
        opt = train.parse_args(started[name])
        assert (opt.start_from, opt.seed) == (start, 3), name
        assert opt.checkpoint_path == f"out/checkpoints/{name}"
    # nothing else of a stage moves with its start
    for name in ("xe", "wxe"):
        assert _without_start(started[name]) == _without_start(
            stage_chain.stage_argv("out", seed=3)[name])


@pytest.fixture(scope="module")
def init_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("init")
    infos = stage_chain.write_init(TINY, str(root / "init"))
    return root, infos


def test_the_init_is_step_0_with_the_options(init_dir):
    root, infos = init_dir
    assert (infos["best_step"], infos["last_step"]) == (0, 0)
    assert infos["best_score"] == 0.0 and infos["init_seed"] == 5
    assert infos["opt"]["rnn_size"] == 8 and infos["opt"]["seed"] == 5
    payload = checkpoint.load(str(root / "init"))
    assert payload["step"] == 0 and set(payload["model"])
    with pytest.raises(FileExistsError, match="already holds checkpoint "
                                              "step 0"):
        stage_chain.write_init(TINY, str(root / "init"))


def test_xe_from_the_init_ends_where_xe_from_scratch_ends(init_dir,
                                                          tmp_path):
    """The init stage writes the model the train CLI builds before its
    first step: XE from it at the same seed is XE from scratch."""
    root, _ = init_dir
    assert train.main(TINY + ["--checkpoint_path",
                              str(tmp_path / "scratch")]) == 0
    assert train.main(TINY + ["--checkpoint_path", str(tmp_path / "from"),
                              "--start_from", str(root / "init")]) == 0
    a = checkpoint.load(str(tmp_path / "scratch"), best=False)
    b = checkpoint.load(str(tmp_path / "from"), best=False)
    assert a["step"] == b["step"] == 4
    for key, value in a["model"].items():
        assert torch.equal(value, b["model"][key]), key


def test_the_init_goes_through_import_from_torch_and_back_bit_for_bit(
        init_dir):
    root, infos = init_dir
    proc = subprocess.run(
        [sys.executable, str(REPO / "import_from_torch.py"),
         "--checkpoint_path", str(root / "init"), "--out_dir",
         str(root / "ref")],
        capture_output=True, text=True, timeout=240, cwd=REPO,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
             "HOME": str(root)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["best_step"] == 0
    want = checkpoint.load(str(root / "init"))["model"]
    vocab = int(want["logit.weight"].shape[0])
    jm = JaxCaptionModel(vocab_size=vocab, embed_size=8, hidden_size=8,
                         attn_size=8, dropout_rate=0.0)
    target = create_train_state(jm, jax.random.PRNGKey(0),
                                [(2, 6), (1, 5)], 6, 1,
                                make_optimizer()[0]).params
    ref = JaxCheckpointManager(str(root / "ref"), readonly=True)
    try:
        assert ref.best_step == 0
        restored = jax.tree_util.tree_map(
            np.asarray, ref.restore_params(target, best=True))
    finally:
        ref.close()
    back = from_flax(restored)
    assert set(back) == set(want)
    for key, value in want.items():
        assert torch.equal(back[key], value), key


def test_the_init_stage_of_the_cli(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(stage_chain, "stage_argv",
                        lambda out_dir, *a, **k: {"xe": TINY})
    assert stage_chain.main(["--out_dir", str(tmp_path), "--stages",
                             "init"]) == 0
    assert "stage init: the initialization at seed 123" \
        in capsys.readouterr().out
    payload = checkpoint.load(str(tmp_path / "checkpoints" / "init"))
    assert payload["step"] == 0
