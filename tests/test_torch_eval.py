"""The port's evaluation path against the reference's, on the CPU: the
scorers (BLEU, ROUGE-L, METEOR_approx and ``language_eval``) on the same
predictions within 1e-12; the recorded beam-5 scores of the reference's
chain reproduced from their predictions against the val references the
port's generator rebuilds; ``python -m cst_captioning_tpu_torch.eval``
on a checkpoint of converted reference weights against the reference's
``eval_split`` (token-identical predictions, equal scores); the serving
engine and ``serve --checkpoint_path`` against the eval's predictions;
validation's ``--fast_val`` / ``--eval_metric``; and the eval CLI's
refusal to run on the CPU unless asked.
"""

import io
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.data import synthetic as jsynthetic
from cst_captioning_tpu.data.dataset import CaptionDataset
from cst_captioning_tpu.data.loader import CaptionLoader as JaxLoader
from cst_captioning_tpu.metrics import bleu as jbleu
from cst_captioning_tpu.metrics import coco_eval as jcoco
from cst_captioning_tpu.metrics import meteor as jmeteor
from cst_captioning_tpu.metrics import rouge as jrouge
from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu.training.evaluation import eval_split as jax_eval
from cst_captioning_tpu_torch import eval as port_eval
from cst_captioning_tpu_torch import serve, train
from cst_captioning_tpu_torch.metrics import bleu, coco_eval, meteor, rouge
from cst_captioning_tpu_torch.metrics.tokenizer import tokenize_corpus
from cst_captioning_tpu_torch.serving.server import CaptionServer
from cst_captioning_tpu_torch.serving.engine import ServingEngine
from cst_captioning_tpu_torch.serving.buckets import parse_buckets
from cst_captioning_tpu_torch.training import checkpoint
from cst_captioning_tpu_torch.training.trainer import (Trainer,
                                                       build_splits)
from cst_captioning_tpu_torch.weights import from_flax

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-12

REFS = {
    "v0": ["A man is cooking in the kitchen.", "a man cooks food",
           "someone is cooking"],
    "v1": ["a dog runs in the park", "the dog is running outside",
           "a dog playing with a ball"],
    "v2": ["a woman sings on stage", "a woman is singing"],
    "v3": ["two people are dancing", "people dance at a party",
           "a couple is dancing together"],
    "v4": ["a cat sleeps", "the cat is sleeping on the bed"],
}
PREDS = [
    {"image_id": "v0", "caption": "a man is cooking"},
    {"image_id": "v1", "caption": ""},                       # empty
    {"image_id": "v2", "caption": "woman"},                  # one word
    {"image_id": "v3", "caption": "dancing dancing dancing dancing"},
    {"image_id": "v4", "caption": "the cat is sleeping sleeping"},
]


def _close(got, want, tol=TOL):
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= tol * max(1.0, abs(want[k])), k


def _tok(preds=PREDS):
    res = tokenize_corpus({p["image_id"]: [p["caption"]] for p in preds})
    gts = tokenize_corpus({k: REFS[k] for k in res})
    return gts, res


def test_bleu_rouge_meteor_equal_the_reference():
    gts, res = _tok()
    got, segs = bleu.compute_bleu(gts, res, n=4)
    want, wsegs = jbleu.compute_bleu(gts, res, n=4)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=0)
    for a, b in zip(segs, wsegs):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=0)
    for ours, theirs in ((rouge.compute_rouge, jrouge.compute_rouge),
                         (meteor.compute_meteor, jmeteor.compute_meteor)):
        g, gs = ours(gts, res)
        w, ws = theirs(gts, res)
        assert abs(g - w) <= TOL
        np.testing.assert_allclose(gs, ws, rtol=TOL, atol=0)
    # The empty caption scores 0; the repeated token is clipped.
    assert gs[1] == 0.0
    assert meteor._porter_stem("running") == jmeteor._porter_stem("running")


@pytest.mark.parametrize("scorers", [
    None, ("Bleu",), ("METEOR",), ("METEOR_approx", "ROUGE_L"),
    ("CIDEr",), ("CIDEr", "CIDEr-plain")],
    ids=["all", "bleu", "meteor", "meteor-approx-rouge", "cider",
         "cider-plain"])
def test_language_eval_equals_the_reference(scorers):
    got = coco_eval.language_eval(PREDS, REFS, scorers=scorers)
    want = jcoco.language_eval(PREDS, REFS, scorers=scorers)
    _close(got, want)
    if scorers is None:
        assert set(got) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4",
                            "METEOR_approx", "ROUGE_L", "CIDEr"}


def test_language_eval_refuses_ids_without_references(tmp_path):
    bad = PREDS + [{"image_id": "v9", "caption": "a man"}]
    with pytest.raises(KeyError, match="without references"):
        coco_eval.language_eval(bad, REFS)
    with pytest.raises(KeyError, match="without references"):
        jcoco.language_eval(bad, REFS)
    # A coco-format annotations file reads into the same references.
    path = tmp_path / "refs.json"
    path.write_text(json.dumps({"annotations": [
        {"image_id": k, "caption": c} for k, caps in REFS.items()
        for c in caps]}))
    assert coco_eval.load_cocofmt_refs(str(path)) == REFS
    _close(coco_eval.language_eval(PREDS, str(path)),
           jcoco.language_eval(PREDS, REFS))
    assert coco_eval.score_key("METEOR") == jcoco.score_key("METEOR") == \
        "METEOR_approx"
    assert coco_eval.score_key("Bleu_4") == "Bleu_4"


@pytest.fixture(scope="module")
def chain_val_refs():
    """The val references of the reference chain's spec
    (``artifacts/cpu512_healthy/SCALE_SPEC.json``: 512 + 128 videos, rich
    vocabulary 400, 20 captions, max_length 30, seed 0), rebuilt by the
    port's generator."""
    spec = json.loads((REPO / "artifacts/cpu512_healthy/SCALE_SPEC.json")
                      .read_text())
    opt = train.parse_args([
        "--synthetic_videos", str(spec["num_videos"]),
        "--synthetic_val_videos", str(spec["num_val"]),
        "--synthetic_rich_vocab", str(spec["rich_vocab"]),
        "--feat_shapes", ",".join(f"{t}x{d}" for t, d in
                                  zip(spec["feat_times"], spec["feat_dims"])),
        "--captions_per_video", "20", "--max_length", "30"])
    _, val = build_splits(opt, train_features=False)
    return val.refs


@pytest.mark.parametrize("stage", ["xe", "wxe", "cst_scb_sample"])
def test_recorded_beam5_scores_reproduce(chain_val_refs, stage):
    recorded = json.loads((REPO / f"artifacts/cpu512_healthy/"
                                  f"{stage}_beam5.json").read_text())
    assert len(recorded["predictions"]) == 128
    got = coco_eval.language_eval(recorded["predictions"], chain_val_refs)
    _close(got, recorded["scores"], tol=1e-9)


# -- the eval CLI against the reference's eval_split ----------------------

SMALL = ["--synthetic_videos", "12", "--synthetic_val_videos", "7",
         "--captions_per_video", "5", "--feat_shapes", "3x8,1x5",
         "--rnn_size", "16", "--input_encoding_size", "16",
         "--att_size", "16", "--max_length", "8", "--batch_size", "4",
         "--seq_per_img", "5", "--device", "cpu"]


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """A port checkpoint holding a reference model's weights (converted
    by ``from_flax``) with the SMALL training options, the reference's
    val split of the same spec, and the reference's beam-3 eval."""
    root = tmp_path_factory.mktemp("eval_slice")
    opt = train.parse_args(SMALL + ["--checkpoint_path", str(root / "ck")])
    spec = jsynthetic.SyntheticSpec(
        num_videos=12, captions_per_video=5, max_len=8, feat_dims=(8, 5),
        feat_times=(3, 1), seed=0)
    train_paths = jsynthetic.generate(str(root), "train", spec)
    with CaptionDataset(jsynthetic.split_paths(train_paths)) as ds:
        vocab = ds.vocab
    val_paths = jsynthetic.generate(
        str(root), "val", jsynthetic.SyntheticSpec(**{**spec.__dict__,
                                                      "num_videos": 7}),
        vocab=vocab)
    jm = JaxCaptionModel(vocab_size=vocab.size_with_pad, embed_size=16,
                         hidden_size=16, attn_size=16, dropout_rate=0.0)
    feats = [jnp.zeros((2, 3, 8)), jnp.zeros((2, 1, 5))]
    params = jax.tree_util.tree_map(np.array, jm.init(
        jax.random.PRNGKey(3), feats, np.zeros((2, 8), np.int32))["params"])
    checkpoint.save(opt.checkpoint_path, checkpoint.BEST, {
        "model": from_flax(params), "step": 0, "best_score": 0.0,
        "score": 0.0, "opt": {k: v for k, v in vars(opt).items()
                              if isinstance(v, (str, int, float,
                                                type(None)))}})
    with CaptionDataset(jsynthetic.split_paths(val_paths)) as ds:
        loader = JaxLoader(ds, batch_size=4, seq_per_img=1, shuffle=False)
        preds, scores = jax_eval(jm, params, loader, ds.vocab, 8,
                                 ds.references(), beam_size=3,
                                 decode_chunk=8)
    return {"dir": opt.checkpoint_path, "preds": preds, "scores": scores,
            "root": root}


def _eval(converted, *extra):
    result = converted["root"] / "result.json"
    rc = port_eval.main(["--checkpoint_path", converted["dir"],
                         "--beam_size", "3", "--batch_size", "4",
                         "--device", "cpu", "--result_file", str(result),
                         *extra])
    assert rc == 0
    return json.loads(result.read_text())


@pytest.mark.parametrize("kernel", ["reference", "fused"])
def test_eval_cli_equals_the_reference_eval_split(converted, kernel,
                                                  capsys):
    out = _eval(converted, "--decode_kernel", kernel)
    assert out["predictions"] == converted["preds"]
    lengths = {len(p["caption"].split()) for p in out["predictions"]}
    assert len(lengths) > 1, "captions should end at mixed lengths"
    _close(out["scores"], converted["scores"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == \
        out["scores"]


def test_eval_cli_serving_engine_parity(converted):
    legacy = _eval(converted, "--decode_kernel", "fused")
    served = _eval(converted, "--decode_kernel", "fused", "--engine",
                   "serving", "--eval_batch_size", "3")
    assert served["predictions"] == legacy["predictions"]
    _close(served["scores"], legacy["scores"])


def test_serving_engine_parity_failure_raises(converted, monkeypatch):
    def garbled(*args, **kw):
        return [{"image_id": "val_video0", "caption": "not it"}]

    monkeypatch.setattr(port_eval, "serve_decode_split", garbled)
    with pytest.raises(RuntimeError, match="parity FAILED"):
        _eval(converted, "--engine", "serving")


def test_serve_checkpoint_captions_equal_eval(converted):
    want = {p["image_id"]: p["caption"]
            for p in _eval(converted, "--decode_kernel", "fused")[
                "predictions"]}
    opt = serve.parse_args(["--checkpoint_path", converted["dir"],
                            "--beam_size", "3", "--device", "cpu"])
    model, vocab, shapes, feats_for = serve.build_backend(opt)
    assert opt.max_length == 8 and shapes == [(3, 8), (1, 5)]
    assert feats_for("v0") is None and feats_for("val_video7") is None
    engine = ServingEngine(model, shapes, max_len=opt.max_length,
                           beam_size=3, decode_chunk=opt.decode_chunk,
                           bucket_sizes=parse_buckets(opt.serve_buckets))
    out = io.StringIO()
    lines = [json.dumps({"id": i, "video_id": v}) + "\n"
             for i, v in enumerate(want)]
    assert CaptionServer(engine, vocab, feats_for, out=out).run_stdin(
        lines=lines) == 0
    got = {r["video_id"]: r["caption"]
           for r in map(json.loads, out.getvalue().splitlines())}
    assert got == want


def test_eval_cli_raises_without_gpu_unless_cpu(converted, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--checkpoint_path", converted["dir"], "--beam_size", "3",
            "--batch_size", "4"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_eval.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_backend(serve.parse_args(
            ["--checkpoint_path", converted["dir"]]))
    assert port_eval.main(argv + ["--device", "cpu"]) == 0


# -- validation: --fast_val and --eval_metric ------------------------------

@pytest.mark.parametrize("metric,keys", [
    ("CIDEr", {"CIDEr"}),
    ("Bleu_4", {"CIDEr", "Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"}),
    ("METEOR", {"CIDEr", "METEOR_approx"}),
    ("ROUGE_L", {"CIDEr", "ROUGE_L"})])
def test_fast_val_scores_cider_and_the_selection_metric(tmp_path, metric,
                                                        keys):
    opt = train.parse_args(SMALL + [
        "--max_epochs", "2", "--fast_val", "1", "--eval_metric", metric,
        "--checkpoint_path", str(tmp_path / "ck")])
    result = Trainer(opt).train()
    history = result["history"]
    assert all(set(h) - {"step"} == keys for h in history)
    key = coco_eval.score_key(metric)
    assert result["best_score"] == max(h[key] for h in history)
    assert not math.isnan(result["best_score"])


def test_full_validation_and_unknown_metric(tmp_path):
    opt = train.parse_args(SMALL + ["--checkpoint_path",
                                    str(tmp_path / "ck")])
    scores = Trainer(opt).validate()
    assert set(scores) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4",
                           "METEOR_approx", "ROUGE_L", "CIDEr"}
    opt.eval_metric = "SPICE"
    with pytest.raises(ValueError, match="--eval_metric 'SPICE'"):
        Trainer(opt)
