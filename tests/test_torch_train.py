"""The port's training steps and train CLI against the reference's.

XE/WXE: the loss and every parameter gradient of one teacher-forced step
against ``jax.value_and_grad`` of ``make_xe_step``'s loss (dropout 0, the
reference's attention in interpret-mode Pallas or plain), with the port's
attention on K1 (the plain version on the CPU, differentiated by the K1
Function's backward) or plain.  RL: the same against
``make_rl_grad_step``'s loss.  Gradients within 1e-5 * max(1, max|g|) per
tensor, converted to the port's layout by ``weights.from_flax``.  Then a
tiny XE -> WXE -> CST chain through the CLI on the CPU, and the CLI's
refusal to run on the CPU unless asked.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu.ops.losses import (cross_entropy_loss, reward_loss,
                                           token_logprobs)
from cst_captioning_tpu_torch import train
from cst_captioning_tpu_torch.training import checkpoint, steps
from cst_captioning_tpu_torch.training.state import Optimizer
from cst_captioning_tpu_torch.weights import from_flax, model_from_flax

B, S, H, E, A, V, L = 3, 4, 16, 16, 16, 30, 8
FEAT_SHAPES = ((4, 8), (1, 5))
GRAD_TOL = 1e-5


def _setup(use_pallas):
    rng = np.random.default_rng(0)
    feats = [rng.normal(size=(B,) + s).astype(np.float32)
             for s in FEAT_SHAPES]
    labels = rng.integers(1, V, size=(B * S, L)).astype(np.int32)
    labels[0, 3:] = 0
    labels[5, 6:] = 0
    weights = rng.uniform(0.3, 1.8, size=B * S).astype(np.float32)
    jm = JaxCaptionModel(vocab_size=V, embed_size=E, hidden_size=H,
                         attn_size=A, dropout_rate=0.0,
                         use_pallas_attention=use_pallas)
    params = jm.init(jax.random.PRNGKey(1), [jnp.asarray(f) for f in feats],
                     labels, S)["params"]
    return jm, params, feats, labels, weights


def _assert_grads_close(model, jax_grads):
    want = from_flax(jax.tree_util.tree_map(np.asarray, jax_grads))
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        scale = max(1.0, float(np.abs(ref).max()))
        err = float(np.abs(p.grad.numpy() - ref).max())
        assert err <= GRAD_TOL * scale, (name, err)


def _port(params, use_kernel):
    return model_from_flax(jax.tree_util.tree_map(np.asarray, params),
                           device="cpu", use_kernel_attention=use_kernel,
                           drop_prob=0.0)


@pytest.mark.parametrize("k1_port,k1_ref,weighted", [
    (True, True, True), (False, False, False), (True, False, True)])
def test_xe_loss_and_gradients_match_reference(k1_port, k1_ref, weighted):
    jm, params, feats, labels, weights = _setup(k1_ref)
    w = weights if weighted else np.ones_like(weights)
    jfeats = [jnp.asarray(f) for f in feats]

    def loss_fn(p):   # make_xe_step's loss, dropout 0
        logits = jm.apply({"params": p}, jfeats, labels, S, train=True,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return cross_entropy_loss(logits, labels, jnp.asarray(w))

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    model = _port(params, k1_port)
    opt = Optimizer(model.parameters(), learning_rate=0.0)
    out = steps.xe_step(model, opt, [torch.from_numpy(f) for f in feats],
                        torch.from_numpy(labels).long(), torch.from_numpy(w),
                        S, torch.Generator().manual_seed(0))
    assert abs(out["loss"].item() - float(loss_j)) <= 1e-5
    assert abs(out["grad_norm"].item()
               - float(optax.global_norm(grads_j))) <= 1e-5
    _assert_grads_close(model, grads_j)


@pytest.mark.parametrize("k1", [True, False])
def test_rl_loss_and_gradients_match_reference(k1):
    jm, params, feats, labels, _ = _setup(k1)
    adv = np.random.default_rng(5).normal(size=B * S).astype(np.float32)
    jfeats = [jnp.asarray(f) for f in feats]

    def loss_fn(p):   # make_rl_grad_step's loss
        logits = jm.apply({"params": p}, jfeats, labels, S, train=False)
        return reward_loss(token_logprobs(logits, labels), labels,
                           jnp.asarray(adv))

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    model = _port(params, k1)
    opt = Optimizer(model.parameters(), learning_rate=0.0)
    out = steps.rl_grad_step(model, opt, [torch.from_numpy(f) for f in feats],
                             torch.from_numpy(labels).long(),
                             torch.from_numpy(adv), S)
    assert abs(out["loss"].item() - float(loss_j)) <= 1e-5
    _assert_grads_close(model, grads_j)


def test_dropout_sites_and_generator():
    """``train=True`` with drop_prob 0.5: logits change, the same
    generator seed gives the same logits, and ``train=False`` ignores
    dropout."""
    jm, params, feats, labels, _ = _setup(False)
    model = model_from_flax(jax.tree_util.tree_map(np.asarray, params),
                            device="cpu")
    tf = [torch.from_numpy(f) for f in feats]
    tl = torch.from_numpy(labels).long()
    with torch.no_grad():
        plain = model(tf, tl, S)
        a = model(tf, tl, S, train=True,
                  generator=torch.Generator().manual_seed(3))
        b = model(tf, tl, S, train=True,
                  generator=torch.Generator().manual_seed(3))
        model.drop_prob = model.encoder.drop_prob = 0.0
        model.cell.drop_prob = 0.0
        off = model(tf, tl, S, train=True)
    assert torch.equal(a, b) and not torch.allclose(a, plain)
    assert torch.equal(off, plain)


TINY = ["--device", "cpu", "--synthetic_videos", "12",
        "--synthetic_val_videos", "5", "--captions_per_video", "5",
        "--feat_shapes", "3x8,1x5", "--rnn_size", "16",
        "--input_encoding_size", "16", "--att_size", "16",
        "--batch_size", "4", "--seq_per_img", "5", "--max_length", "8",
        "--decode_chunk", "3", "--log_every", "1", "--pallas_attention", "1"]


def _run(argv, capsys):
    assert train.main(TINY + argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_three_stage_chain_through_the_cli(tmp_path, capsys):
    """XE -> WXE -> CST (greedy baseline, K2 route) as three CLI runs
    chained by ``--start_from``; each stage starts from the previous
    stage's best parameters and writes best.pt, last.pt and infos.json."""
    xe = _run(["--checkpoint_path", str(tmp_path / "xe"),
               "--max_epochs", "2", "--learning_rate", "1e-2"], capsys)
    assert xe["last_step"] == 6 and xe["best_step"] in (3, 6)
    wxe = _run(["--checkpoint_path", str(tmp_path / "wxe"),
                "--start_from", str(tmp_path / "xe"),
                "--use_consensus_weights", "1", "--max_epochs", "1"],
               capsys)
    cst = _run(["--checkpoint_path", str(tmp_path / "cst"),
                "--start_from", str(tmp_path / "wxe"), "--use_rl", "1",
                "--decode_kernel", "fused", "--max_epochs", "1"], capsys)
    for stage, out in (("xe", xe), ("wxe", wxe), ("cst", cst)):
        d = tmp_path / stage
        assert out["checkpoint_path"] == str(d)
        assert {"best.pt", "last.pt", "infos.json"} <= set(os.listdir(d))
        infos = json.loads((d / "infos.json").read_text())
        assert infos["best_score"] == out["best_score"] >= 0.0
    # WXE started from XE's best parameters.
    from cst_captioning_tpu_torch.training.trainer import Trainer
    opt = train.parse_args(TINY + ["--start_from", str(tmp_path / "xe"),
                                   "--use_consensus_weights", "1"])
    warm = Trainer(opt)
    best = checkpoint.load(str(tmp_path / "xe"))["model"]
    for name, p in warm.model.state_dict().items():
        assert torch.equal(p, best[name]), name
    assert warm.loader.consensus_weights is not None


def test_cli_early_stop_and_scb_baselines(tmp_path, capsys):
    """The SCB baselines (scb-gt with beam-2 validation), and the early
    stop once an epoch does not improve on the best."""
    out = _run(["--checkpoint_path", str(tmp_path / "s"), "--use_rl", "1",
                "--rl_baseline", "scb-sample", "--max_epochs", "1"], capsys)
    assert out["last_step"] == 3
    out = _run(["--checkpoint_path", str(tmp_path / "g"), "--use_rl", "1",
                "--rl_baseline", "scb-gt", "--max_epochs", "1",
                "--val_beam_size", "2"], capsys)
    assert out["last_step"] == 3
    out = _run(["--checkpoint_path", str(tmp_path / "p"), "--max_epochs",
                "9", "--max_patience", "1", "--learning_rate", "0"], capsys)
    assert out["last_step"] == 6      # epoch 2 did not improve on epoch 1


def test_cli_cst_with_bfloat16_noise(tmp_path, capsys):
    """``--use_bfloat16 1``: CST's rollouts draw the reference's bfloat16
    Gumbel noise (128 values, all below 5), in the logits' dtype; the
    parameters stay float32."""
    out = _run(["--checkpoint_path", str(tmp_path / "b"), "--use_rl", "1",
                "--rl_baseline", "scb-sample", "--use_bfloat16", "1",
                "--max_epochs", "1"], capsys)
    assert out["last_step"] == 3
    from cst_captioning_tpu_torch.training.trainer import Trainer
    trainer = Trainer(train.parse_args(TINY + ["--use_bfloat16", "1"]))
    noise = trainer.noise(0, (300, 300))
    assert noise.dtype == torch.bfloat16 and noise.max().item() < 5.0
    assert len(noise.unique()) <= 128
    assert trainer.model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())


def test_bf16_parity_tool_on_a_trained_checkpoint(tmp_path, capsys):
    """``tools/bf16_parity.py`` on an XE checkpoint of the train CLI: one
    JSON line with the parity gate's verdict over the float32 and the
    bfloat16 decodes of the val split, and the exit code it implies; a
    bfloat16 model has nothing to gate."""
    from cst_captioning_tpu_torch.ops.bf16_decode import parity_gate
    from cst_captioning_tpu_torch.tools import bf16_parity

    _run(["--checkpoint_path", str(tmp_path / "xe"), "--max_epochs", "2",
          "--learning_rate", "1e-2"], capsys)
    args = ["--checkpoint_path", str(tmp_path / "xe"), "--device", "cpu",
            "--batch_size", "4"]
    for bound in ("0.02", "100"):
        rc = bf16_parity.main(args + ["--cider_delta_bound", bound])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["supported"] and out["num_videos"] == 5
        assert 0.0 <= out["caption_agreement"] <= 1.0
        want = parity_gate(out["cider_fp32"], out["cider_bf16"],
                           float(bound))
        assert {k: out[k] for k in want} == want
        assert rc == (0 if out["within_bound"] else 1)
    assert out["within_bound"] and rc == 0
    assert bf16_parity.main(args + ["--use_bfloat16", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == {"supported": False,
                   "reason": "model compute dtype is already bfloat16",
                   "kernel_recommendation": "reference"}
    assert bf16_parity.main(["--checkpoint_path", str(tmp_path / "no"),
                             "--device", "cpu"]) == 2


def test_train_cli_raises_without_gpu_unless_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(argv + ["--checkpoint_path", str(tmp_path)])
