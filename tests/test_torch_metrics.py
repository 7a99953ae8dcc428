"""The port's own copies of the reward metrics against the reference's:
tokenizer, CIDEr-D (corpus and per-call document frequencies), the
consensus scores and WXE weights, and ``RewardComputer``'s advantages for
the three baselines (the reference on its Python scorer).  Scores within
1e-9."""

import numpy as np
import pytest

from cst_captioning_tpu.data.vocab import Vocab as JaxVocab
from cst_captioning_tpu.metrics import ciderd as jciderd
from cst_captioning_tpu.metrics import consensus as jconsensus
from cst_captioning_tpu.metrics import tokenizer as jtokenizer
from cst_captioning_tpu.training.rewards import \
    RewardComputer as JaxRewardComputer
from cst_captioning_tpu_torch.data.vocab import Vocab
from cst_captioning_tpu_torch.metrics import ciderd, consensus, tokenizer
from cst_captioning_tpu_torch.training.rewards import RewardComputer

WORDS = ["a", "man", "woman", "dog", "is", "running", "cooking", "in",
         "the", "park", "kitchen", "with", "ball", "red", "big"]
TOL = 1e-9


def _corpus(seed=0, n_videos=6, n_caps=5):
    rng = np.random.default_rng(seed)
    refs = {}
    for v in range(n_videos):
        base = list(rng.choice(WORDS, size=6))
        caps = []
        for j in range(n_caps):
            words = base if j % 2 == 0 else base[:4] + list(
                rng.choice(WORDS, size=int(rng.integers(1, 4))))
            caps.append(" ".join(words))
        refs[f"v{v}"] = caps
    return refs


def test_tokenizer_matches_reference():
    caps = ["A man... isn't (really) cooking the dogs' dinner.",
            "cannot. u.s. 'tis \"quoted\"!", "Two--dogs; running, fast?",
            "   the   CAT's  toy  "]
    assert [tokenizer.tokenize(c) for c in caps] == \
        [jtokenizer.tokenize(c) for c in caps]
    corpus = {"a": caps[:2], "b": caps[2:]}
    assert tokenizer.tokenize_corpus(corpus) == \
        jtokenizer.tokenize_corpus(corpus, use_native=False)


@pytest.mark.parametrize("mode", ["corpus", "refs"])
def test_ciderd_matches_reference(mode):
    refs = _corpus()
    rng = np.random.default_rng(1)
    res = [{"image_id": k, "caption": [" ".join(rng.choice(WORDS, size=5))]}
           for k in refs] + [{"image_id": "v0", "caption": [refs["v0"][0]]},
                             {"image_id": "v1", "caption": [""]}]
    gts = {r["image_id"]: refs[r["image_id"]] for r in res}
    if mode == "corpus":
        df, n = ciderd.build_corpus_df(refs)
        jdf, jn = jciderd.build_corpus_df(refs)
        assert df == jdf and n == jn
        ours = ciderd.CiderD(df=df, ref_len=float(n))
        theirs = jciderd.CiderD(df=jdf, ref_len=float(jn))
    else:
        ours = ciderd.CiderD(df_mode="refs")
        theirs = jciderd.CiderD(df_mode="refs")
    got = ours.compute_score(gts, res)
    want = theirs.compute_score(gts, res)
    assert abs(got[0] - want[0]) <= TOL
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=TOL)


def test_consensus_scores_and_weights_match_reference():
    refs = _corpus(2, n_videos=8, n_caps=7)
    refs["single"] = ["a dog is running"]
    got = consensus.compute_consensus_scores(refs)
    want = jconsensus.compute_consensus_scores(refs, native=False)
    assert got.keys() == want.keys()
    for vid in want:
        np.testing.assert_allclose(got[vid], want[vid], rtol=0, atol=TOL)
    for temp in (1.0, 0.5):
        gw = consensus.normalize_weights(got, temp)
        ww = jconsensus.normalize_weights(want, temp)
        for vid in ww:
            np.testing.assert_allclose(gw[vid], ww[vid], rtol=0, atol=TOL)


@pytest.mark.parametrize("baseline,scb_captions", [
    ("greedy", 0), ("scb-sample", 0), ("scb-gt", 0), ("scb-gt", 2)])
def test_reward_computer_matches_reference(baseline, scb_captions):
    refs = _corpus(3, n_videos=4, n_caps=5)
    ix_to_word = {i + 1: w for i, w in enumerate(WORDS)}
    tok = tokenizer.tokenize_corpus(refs)
    df, n = ciderd.build_corpus_df(tok)
    cons = consensus.compute_consensus_scores(tok)
    s = 3
    rng = np.random.default_rng(4)
    sampled = rng.integers(0, len(WORDS) + 1, size=(4 * s, 7))
    sampled[:, 0] = rng.integers(1, len(WORDS) + 1, size=4 * s)
    greedy = rng.integers(1, len(WORDS) + 1, size=(4, 7))
    greedy[0, 3:] = 0
    vids = list(refs)
    ours = RewardComputer(Vocab(ix_to_word),
                          ciderd.CiderD(df=df, ref_len=float(n)), tok, s,
                          baseline=baseline, consensus_scores=cons,
                          scb_captions=scb_captions)
    theirs = JaxRewardComputer(JaxVocab(ix_to_word),
                               jciderd.CiderD(df=df, ref_len=float(n)), tok,
                               s, baseline=baseline, consensus_scores=cons,
                               scb_captions=scb_captions)
    got_adv, got_stats = ours(vids, sampled, greedy)
    want_adv, want_stats = theirs(vids, sampled, greedy)
    assert got_adv.dtype == np.float32
    np.testing.assert_array_equal(got_adv, want_adv)
    for key in want_stats:
        assert abs(got_stats[key] - want_stats[key]) <= TOL, key


def test_reward_computer_refuses_what_the_reference_refuses():
    vocab = Vocab({1: "a"})
    scorer = ciderd.CiderD(df={}, ref_len=1.0)
    with pytest.raises(ValueError, match="seq_per_img"):
        RewardComputer(vocab, scorer, {}, 1, baseline="scb-sample")
    with pytest.raises(ValueError, match="consensus"):
        RewardComputer(vocab, scorer, {}, 2, baseline="scb-gt")
    with pytest.raises(ValueError, match="greedy"):
        RewardComputer(vocab, scorer, {"v": ["a"]}, 1)(
            ["v"], np.ones((1, 2), np.int64))
