"""The port's Transformer caption decoder against the reference's, on the
CPU, with weights converted from the Flax tree (``weights.from_flax``).

- teacher-forced logits, float32 within 1e-5 * max(1, max|ref|), and
  bfloat16 within the tolerance stated at ``BF16_TOL``;
- ``decode`` over the (buffer, position) carry, step by step and in
  blocks of L > 1, against the reference's ``decode``; the port's prefix
  decode against its full-buffer decode;
- the train CLI's XE -> CST (fused, and the host reward path) -> beam-5
  eval with ``--model_type transformer``, and XE -> fused CST -> beam-5
  eval of manet, the 2-layer and the pooled LSTM;
- a JAX-trained transformer checkpoint (three reference XE steps, saved
  through the reference's ``CheckpointManager``) exported by
  ``export_for_torch.py checkpoint`` and evaluated by the port's eval
  CLI: captions and scores equal to the reference's evaluation's;
- the transformer refused by the serving engine and the serve CLI, with
  the reference's reason.
"""

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
from cst_captioning_tpu.data.loader import CaptionLoader as JaxLoader
from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu.training.checkpoint import (
    CheckpointManager as JaxCheckpointManager)
from cst_captioning_tpu.training.evaluation import eval_split as jax_eval
from cst_captioning_tpu.training.state import (create_train_state,
                                               make_optimizer)
from cst_captioning_tpu.training.steps import make_xe_step
from cst_captioning_tpu_torch import eval as port_eval
from cst_captioning_tpu_torch import serve, train
from cst_captioning_tpu_torch.serving.engine import (TRANSFORMER_REFUSAL,
                                                     ServingEngine)
from cst_captioning_tpu_torch.tools.stage_chain import data_argv
from cst_captioning_tpu_torch.training import checkpoint
from cst_captioning_tpu_torch.weights import (load_exported_checkpoint,
                                              model_from_flax)

REPO = Path(__file__).resolve().parent.parent
B, H, V, L, HEADS = 4, 16, 30, 8, 2
FEAT_SHAPES = ((4, 8), (1, 5))
TOL = 1e-5
# bfloat16 keeps 8 significant bits: one rounding is up to 2^-8 relative,
# and the two decoders round at different points inside the fused ops
# (the matmuls' accumulation order, the softmax and LayerNorm
# reductions), over two blocks and the vocab head: logits within 2^-5 *
# max(1, max|ref|) (a few bfloat16 steps at the logits' magnitude).
BF16_TOL = 2.0 ** -5


def _close(got, want, tol=TOL):
    want = np.asarray(want, dtype=np.float32)
    err = float(np.abs(np.asarray(got, dtype=np.float32) - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _feats(seed=0, b=B):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b,) + s).astype(np.float32)
            for s in FEAT_SHAPES]


def _jax(dtype=jnp.float32, max_len=L + 1):
    jm = JaxCaptionModel(vocab_size=V, hidden_size=H, dropout_rate=0.0,
                         decoder_type="transformer", num_heads=HEADS,
                         num_tx_layers=2, tx_max_len=max_len, dtype=dtype)
    variables = jm.init(jax.random.PRNGKey(0),
                        [jnp.asarray(f) for f in _feats()],
                        np.zeros((B, L), np.int32))
    return jm, jax.tree_util.tree_map(np.asarray, variables["params"])


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("seq_per_img", [1, 2])
def test_teacher_forced_logits_match_reference(seq_per_img):
    jm, params = _jax()
    model = model_from_flax(params, device="cpu")
    feats = _feats(1)
    labels = np.random.default_rng(2).integers(
        1, V, size=(B * seq_per_img, L)).astype(np.int32)
    want = jm.apply({"params": params}, [jnp.asarray(f) for f in feats],
                    labels, seq_per_img, train=False)
    with torch.no_grad():
        got = model(_t(feats), torch.from_numpy(labels).long(), seq_per_img)
    _close(got.numpy(), want)


def test_bfloat16_teacher_forced_logits_match_reference():
    jm, params = _jax(jnp.bfloat16)
    # The reference keeps pos_embed in its compute dtype; the port keeps
    # every parameter float32 and casts at use: the same bfloat16 values.
    model = model_from_flax(params, device="cpu", dtype=torch.bfloat16)
    feats = _feats(3)
    labels = np.random.default_rng(4).integers(
        1, V, size=(B, L)).astype(np.int32)
    want = jm.apply({"params": params}, [jnp.asarray(f) for f in feats],
                    labels, train=False)
    with torch.no_grad():
        got = model(_t(feats), torch.from_numpy(labels).long())
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           BF16_TOL)


@pytest.mark.parametrize("block", [1, 3])
def test_decode_over_the_buffer_matches_reference(block):
    """Blocks of ``block`` tokens written at the carry's position: the
    logits of each block against the reference's ``decode`` (which
    recomputes the whole buffer), and the port's prefix decode against
    its full-buffer decode."""
    jm, params = _jax()
    model = model_from_flax(params, device="cpu")
    variables = {"params": params}
    feats = _feats(5)
    tokens = np.random.default_rng(6).integers(
        1, V, size=(B, L)).astype(np.int32)
    mem, pm, pooled = jm.apply(variables, [jnp.asarray(f) for f in feats],
                               method="encode")
    carry_j = jm.apply(variables, pooled, L, method="init_carry")
    with torch.no_grad():
        tmem, tpm, tpooled = model.encode(_t(feats))
        carry = model.init_carry(tpooled, L)
        full = model.init_carry(tpooled, L)
        for pos in range(0, L, block):
            blk = tokens[:, pos:pos + block]
            carry_j, want = jm.apply(variables, carry_j, blk, mem, pm,
                                     pooled, method="decode")
            carry, got = model.decode(carry, torch.from_numpy(blk).long(),
                                      tmem, tpm, tpooled)
            full, got_full = model.tx.decode(
                full, torch.from_numpy(blk).long(), tmem, tpooled,
                full=True)
            _close(got.numpy(), want)
            _close(got_full.numpy(), got.numpy())
            assert carry[1] == full[1] == int(carry_j[1])
            np.testing.assert_array_equal(carry[0].numpy(),
                                          np.asarray(carry_j[0]))
        with pytest.raises(ValueError, match="past the buffer"):
            model.decode(carry, torch.zeros(B, 1, dtype=torch.long), tmem,
                         tpm, tpooled)


def test_init_carry_and_lengths_are_checked():
    _, params = _jax()
    model = model_from_flax(params, device="cpu")
    pooled = torch.zeros(B, H)
    with pytest.raises(ValueError, match="max_len > 0"):
        model.init_carry(pooled)
    buf, pos = model.init_carry(pooled, 5)
    assert buf.shape == (B, 5) and buf.dtype == torch.long and pos == 0
    with pytest.raises(ValueError, match="exceeds max_len"):
        model(_t(_feats()), torch.ones(B, L + 2, dtype=torch.long))


TINY = ["--device", "cpu", "--synthetic_videos", "12",
        "--synthetic_val_videos", "5", "--captions_per_video", "5",
        "--feat_shapes", "3x8,1x5", "--rnn_size", "16",
        "--batch_size", "4", "--seq_per_img", "5", "--max_length", "8",
        "--decode_chunk", "3", "--log_every", "1",
        "--model_type", "transformer", "--num_heads", "2",
        "--num_tx_layers", "2"]


def _run(argv, capsys):
    assert train.main(TINY + argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_transformer_xe_cst_and_beam_eval_through_the_clis(tmp_path,
                                                           capsys):
    """XE, then fused CST from its best step, then the eval CLI at beam
    5: the transformer behind the same CLIs, its options saved with each
    checkpoint and rebuilt by the eval."""
    xe = _run(["--checkpoint_path", str(tmp_path / "xe"),
               "--max_epochs", "1", "--learning_rate", "1e-2"], capsys)
    cst = _run(["--checkpoint_path", str(tmp_path / "cst"),
                "--start_from", str(tmp_path / "xe"), "--use_rl", "1",
                "--rl_baseline", "scb-sample", "--max_epochs", "1"], capsys)
    host = _run(["--checkpoint_path", str(tmp_path / "host"),
                 "--start_from", str(tmp_path / "xe"), "--use_rl", "1",
                 "--device_rewards", "0", "--max_epochs", "1"], capsys)
    for out in (xe, cst, host):
        assert out["best_score"] >= 0.0 and out["last_step"] == 3
    saved = checkpoint.load(str(tmp_path / "cst"))
    assert saved["opt"]["model_type"] == "transformer"
    assert "tx.blocks.1.cross_attn.query.weight" in saved["model"]
    result = tmp_path / "r.json"
    assert port_eval.main(["--checkpoint_path", str(tmp_path / "cst"),
                           "--beam_size", "5", "--device", "cpu",
                           "--result_file", str(result)]) == 0
    preds = json.loads(result.read_text())["predictions"]
    assert len(preds) == 5
    with pytest.raises(ValueError, match="does not cover"):
        train.main(TINY + ["--checkpoint_path", str(tmp_path / "f"),
                           "--decode_kernel", "fused"])


@pytest.mark.parametrize("variant", [
    ["--fusion_type", "manet", "--decode_kernel", "fused",
     "--pallas_attention", "1"],
    ["--num_layers", "2", "--pallas_attention", "1"],
    ["--use_attention", "0"]], ids=["manet", "lstm2", "pooled"])
def test_lstm_variants_xe_cst_and_beam_eval_through_the_clis(
        variant, tmp_path, capsys):
    tiny = [a for a in TINY if a not in TINY[TINY.index("--model_type"):]]
    for stage, extra in (("xe", ["--learning_rate", "1e-2"]),
                         ("cst", ["--start_from", str(tmp_path / "xe"),
                                  "--use_rl", "1"])):
        assert train.main(tiny + variant + extra + [
            "--checkpoint_path", str(tmp_path / stage),
            "--max_epochs", "1"]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["best_score"] >= 0.0 and out["last_step"] == 3
    saved = checkpoint.load(str(tmp_path / "cst"))["opt"]
    assert [saved[k] for k in ("fusion_type", "num_layers",
                               "use_attention")] == [
        "manet" if "manet" in variant else "temporal",
        2 if "2" in variant else 1, 0 if "0" in variant else 1]
    result = tmp_path / "r.json"
    assert port_eval.main(["--checkpoint_path", str(tmp_path / "cst"),
                           "--beam_size", "5", "--device", "cpu",
                           "--result_file", str(result)]) == 0
    assert len(json.loads(result.read_text())["predictions"]) == 5


SPEC = dict(num_videos=8, captions_per_video=5, max_len=8, feat_dims=(8, 5),
            feat_times=(3, 1), seed=0)


@pytest.fixture(scope="module")
def reference_transformer(tmp_path_factory):
    """A reference transformer trained three XE steps, saved through the
    reference's ``CheckpointManager``, exported by ``export_for_torch.py
    checkpoint`` in its own process, with its val split exported as the
    port's files."""
    root = tmp_path_factory.mktemp("ref_tx")
    train_paths = jsynthetic.generate(str(root), "train",
                                      jsynthetic.SyntheticSpec(**SPEC))
    with JaxDataset(jsynthetic.split_paths(train_paths)) as ds:
        vocab = ds.vocab
        jm = JaxCaptionModel(vocab_size=vocab.size_with_pad, hidden_size=16,
                             dropout_rate=0.0, decoder_type="transformer",
                             num_heads=2, num_tx_layers=2,
                             tx_max_len=ds.seq_length + 1)
        tx, _ = make_optimizer(learning_rate=1e-2)
        state = create_train_state(jm, jax.random.PRNGKey(5),
                                   [(3, 8), (1, 5)], ds.seq_length, 5, tx)
        step = jax.jit(make_xe_step(jm, 5))
        loader = JaxLoader(ds, batch_size=4, seq_per_img=5, seed=0)
        for _ in range(3):
            b = loader.next_batch()
            state, _ = step(state, [jnp.asarray(f) for f in b.feats],
                            jnp.asarray(b.labels), jnp.asarray(b.weights),
                            jax.random.PRNGKey(1))
    jsynthetic.generate(str(root), "val", jsynthetic.SyntheticSpec(
        **dict(SPEC, num_videos=6)), vocab=vocab)
    mgr = JaxCheckpointManager(str(root / "ck"), max_to_keep=1)
    mgr.save(3, state, score=1.0, extra={"opt": {
        "rnn_size": 16, "input_encoding_size": 512, "att_size": 512,
        "max_length": 8, "use_bfloat16": 0, "model_type": "transformer",
        "num_heads": 2, "num_tx_layers": 2, "fusion_type": "temporal",
        "train_info_json": train_paths["info_json"]}})
    mgr.close()
    out = root / "export"
    import export_for_torch
    export_for_torch.export_data(str(root), "val", str(out / "data"))
    proc = subprocess.run(
        [sys.executable, str(REPO / "export_for_torch.py"), "checkpoint",
         "--checkpoint_path", str(root / "ck"), "--out_dir",
         str(out / "ck")], capture_output=True, text=True, timeout=240,
        cwd=REPO, env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
                       "HOME": str(root)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    return {"jm": jm, "root": root, "out": out,
            "params": jax.tree_util.tree_map(np.asarray, state.params)}


def test_exported_transformer_evaluates_as_the_reference(
        reference_transformer, tmp_path):
    rc = reference_transformer
    params, opts, _ = load_exported_checkpoint(str(rc["out"] / "ck"))
    assert opts["model_type"] == "transformer"
    model = model_from_flax(params, device="cpu")
    assert model.decoder_type == "transformer"
    result = tmp_path / "r.json"
    test = data_argv(str(rc["out"] / "data"), "val", "test")
    assert port_eval.main(["--checkpoint_path", str(rc["out"] / "ck"),
                           "--beam_size", "3", "--batch_size", "4",
                           "--device", "cpu", "--result_file", str(result),
                           *test]) == 0
    out = json.loads(result.read_text())
    with JaxDataset(jsynthetic.split_paths({
            "feat_h5": json.dumps([str(rc["root"] / f"val_feat{m}.h5")
                                   for m in range(2)]),
            "label_h5": str(rc["root"] / "val_label.h5"),
            "info_json": str(rc["root"] / "val_info.json"),
            "cocofmt_json": str(rc["root"] / "val_cocofmt.json")})) as ds:
        loader = JaxLoader(ds, batch_size=4, seq_per_img=1, shuffle=False)
        preds, scores = jax_eval(rc["jm"], rc["params"], loader, ds.vocab,
                                 8, ds.references(), beam_size=3,
                                 decode_chunk=8)
    assert out["predictions"] == preds
    for k, v in scores.items():
        assert abs(out["scores"][k] - v) <= 1e-12 * max(1.0, abs(v)), k


def test_serving_refuses_the_transformer(reference_transformer, capsys):
    rc = reference_transformer
    params, _, _ = load_exported_checkpoint(str(rc["out"] / "ck"))
    model = model_from_flax(params, device="cpu")
    with pytest.raises(ValueError, match="per-row decoder state"):
        ServingEngine(model, [(3, 8), (1, 5)], max_len=8)
    test = data_argv(str(rc["out"] / "data"), "val", "test")
    assert serve.main(["--checkpoint_path", str(rc["out"] / "ck"),
                       "--device", "cpu", *test]) == 1
    assert TRANSFORMER_REFUSAL in capsys.readouterr().err
