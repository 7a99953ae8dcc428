"""The port's in-memory synthetic splits and loader against the
reference's generator (written to HDF5 under ``tmp_path``) and its
``CaptionLoader``; and the port's Flax-like initialisation against a
reference ``model.init``.  Data arrays must be identical."""

import json

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.data import synthetic as jsynthetic
from cst_captioning_tpu.data.dataset import CaptionDataset
from cst_captioning_tpu.data.loader import CaptionLoader as JaxLoader
from cst_captioning_tpu.data.vocab import load_vocab
from cst_captioning_tpu.metrics.consensus import load_consensus
from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu_torch.data import synthetic
from cst_captioning_tpu_torch.data.loader import CaptionLoader
from cst_captioning_tpu_torch.metrics.consensus import normalize_weights
from cst_captioning_tpu_torch.models import CaptionModel
from cst_captioning_tpu_torch.weights import from_flax, init_like_flax_

SPECS = {
    "small": dict(num_videos=10, captions_per_video=5, max_len=9,
                  feat_dims=(16, 6), feat_times=(3, 1), seed=0,
                  rich_vocab=0),
    "rich": dict(num_videos=14, captions_per_video=6, max_len=12,
                 feat_dims=(12, 5), feat_times=(2, 1), seed=4,
                 rich_vocab=60),
}


def _reference_split(root, split, spec, vocab=None):
    paths = jsynthetic.generate(str(root), split,
                                jsynthetic.SyntheticSpec(**spec),
                                vocab=vocab)
    return paths, jsynthetic.split_paths(paths)


@pytest.fixture(scope="module", params=sorted(SPECS))
def splits(request, tmp_path_factory):
    spec = SPECS[request.param]
    root = tmp_path_factory.mktemp(request.param)
    train_paths, train_sp = _reference_split(root, "train", spec)
    jvocab = load_vocab(train_paths["vocab_json"])
    val_paths, val_sp = _reference_split(
        root, "val", dict(spec, num_videos=5), vocab=jvocab)
    train = synthetic.generate("train", synthetic.SyntheticSpec(**spec))
    val = synthetic.generate("val", synthetic.SyntheticSpec(
        **dict(spec, num_videos=5)), vocab=train.vocab, consensus=False)
    return (train, train_paths, train_sp), (val, val_paths, val_sp)


def _assert_split_equal(ours, paths, sp):
    with h5py.File(paths["label_h5"], "r") as f:
        np.testing.assert_array_equal(ours.labels, f["labels"][()])
        np.testing.assert_array_equal(ours.label_start,
                                      f["label_start_ix"][()])
        np.testing.assert_array_equal(ours.label_end, f["label_end_ix"][()])
    with open(paths["vocab_json"]) as f:
        assert ours.vocab.to_json() == json.load(f)["ix_to_word"]
    with CaptionDataset(sp) as ds:
        assert ours.video_ids == ds.video_ids
        assert ours.refs == ds.references()
        ix = np.arange(ds.num_videos)
        for got, want in zip(ours.features(ix), ds.features(ix)):
            np.testing.assert_array_equal(got, want)


def test_train_split_equals_reference(splits):
    (ours, paths, sp), _ = splits
    _assert_split_equal(ours, paths, sp)
    want = load_consensus(paths["consensus_pkl"])
    for vid, scores in want.items():
        np.testing.assert_allclose(ours.consensus[vid], scores, rtol=0,
                                   atol=1e-9)


def test_val_split_equals_reference(splits):
    _, (ours, paths, sp) = splits
    _assert_split_equal(ours, paths, sp)
    assert ours.consensus is None


@pytest.mark.parametrize("weighted", [False, True])
def test_loader_stream_equals_reference(splits, weighted):
    (ours, paths, sp), _ = splits
    weights = (normalize_weights(ours.consensus) if weighted else None)
    with CaptionDataset(sp) as ds:
        theirs = JaxLoader(ds, batch_size=3, seq_per_img=4, seed=11,
                           consensus_weights=weights)
        mine = CaptionLoader(ours, batch_size=3, seq_per_img=4, seed=11,
                             consensus_weights=weights)
        assert mine.batches_per_epoch == theirs.batches_per_epoch
        for _ in range(9):                     # across epoch boundaries
            a, b = mine.next_batch(), theirs.next_batch()
            np.testing.assert_array_equal(a.video_ix, b.video_ix)
            np.testing.assert_array_equal(a.labels, b.labels)
            np.testing.assert_array_equal(a.weights, b.weights)
            assert a.video_ids == b.video_ids
            for fa, fb in zip(a.feats, b.feats):
                np.testing.assert_array_equal(fa, fb)
        assert mine.epoch == theirs.epoch
        evals = list(zip(CaptionLoader(ours, 4, seq_per_img=1,
                                       shuffle=False).iter_eval(),
                         JaxLoader(ds, 4, seq_per_img=1,
                                   shuffle=False).iter_eval()))
        assert len(evals) == -(-ours.num_videos // 4)
        for a, b in evals:
            np.testing.assert_array_equal(a.video_ix, b.video_ix)
            assert a.video_ids == b.video_ids


def test_rich_grammar_needs_five_captions():
    with pytest.raises(ValueError, match="captions_per_video"):
        synthetic.generate("train", synthetic.SyntheticSpec(
            captions_per_video=4, rich_vocab=50))


def test_init_like_flax_matches_reference_statistics():
    """Each parameter's spread as the reference's ``model.init`` draws it
    (within 10% at these sizes), zero biases, orthogonal recurrent gate
    blocks and a truncation at two standard deviations."""
    v, e, h, a, dims = 400, 48, 64, 40, (96, 32)
    jm = JaxCaptionModel(vocab_size=v, embed_size=e, hidden_size=h,
                         attn_size=a)
    feats = [jnp.zeros((2, 3, dims[0])), jnp.zeros((2, 1, dims[1]))]
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), feats,
                            jnp.zeros((2, 5), jnp.int32))["params"])
    ref = from_flax(params)
    model = CaptionModel(v, list(dims), embed_size=e, hidden_size=h,
                         attn_size=a)
    init_like_flax_(model, torch.Generator().manual_seed(0))
    again = CaptionModel(v, list(dims), embed_size=e, hidden_size=h,
                         attn_size=a)
    init_like_flax_(again, torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        want = ref[name]
        assert p.shape == want.shape, name
        assert torch.equal(p, dict(again.named_parameters())[name]), name
        if name.endswith("bias"):
            assert not p.any(), name
            continue
        ratio = p.std().item() / want.std().item()
        assert 0.9 < ratio < 1.1, (name, ratio)
    w = model.cell.lstm[0].w.detach()
    for g in range(4):
        blk = w[e + h:, g * h:(g + 1) * h]
        torch.testing.assert_close(blk.T @ blk, torch.eye(h), atol=1e-5,
                                   rtol=0)
        inp = w[:e + h, g * h:(g + 1) * h]
        assert inp.abs().max().item() <= 2 * (1 / (e + h)) ** 0.5 / 0.8796
