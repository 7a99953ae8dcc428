"""The port's native C++ CIDEr-D and PTB tokenizer against the
reference's (``cst_captioning_tpu.native``) and the port's Python
scorer and tokenizer, on seeded corpora; the reward computer on the
native scorer; where the library is built, and what happens without a
compiler; the trainer's choice of scorer.

Tolerances are the reference's own tests': scores within rtol 1e-9,
atol 1e-12 (tests/test_native_ciderd.py), advantages within rtol 1e-5,
atol 1e-7; tokens identical.
"""

import random
import shutil
import string

import numpy as np
import pytest

from cst_captioning_tpu import native as ref_native
from cst_captioning_tpu.data.vocab import Vocab as JaxVocab
from cst_captioning_tpu.metrics.ciderd import CiderD as JaxCiderD
from cst_captioning_tpu.metrics.consensus import \
    compute_consensus_scores as jax_consensus
from cst_captioning_tpu.training.rewards import \
    RewardComputer as JaxRewardComputer
from cst_captioning_tpu_torch import native, train
from cst_captioning_tpu_torch.data.vocab import Vocab
from cst_captioning_tpu_torch.metrics import tokenizer
from cst_captioning_tpu_torch.metrics.ciderd import CiderD, build_corpus_df
from cst_captioning_tpu_torch.training.rewards import RewardComputer
from cst_captioning_tpu_torch.training.trainer import Trainer

RTOL, ATOL = 1e-9, 1e-12
WORDS = ["a", "man", "is", "cooking", "dog", "runs", "the", "park",
         "woman", "sings", "plays", "guitar", "cat", "sleeps"]


def make_refs(num_videos=10, caps_per_video=5, seed=0):
    rng = np.random.default_rng(seed)
    return {f"v{v}": [" ".join(rng.choice(WORDS, int(rng.integers(3, 9))))
                      for _ in range(caps_per_video)]
            for v in range(num_videos)}


def hypotheses(refs, seed=1):
    """Per video one of its own references (scores high) and one random
    caption, grouped per video."""
    rng = np.random.default_rng(seed)
    caps = []
    for v in refs:
        caps.append(refs[v][0])
        caps.append(" ".join(rng.choice(WORDS, int(rng.integers(2, 10)))))
    return caps


def python_scores(scorer, refs, video_ids, captions):
    per_vid = len(captions) // len(video_ids)
    gts = {str(i): list(refs[video_ids[i // per_vid]])
           for i in range(len(captions))}
    res = [{"image_id": str(i), "caption": [c]}
           for i, c in enumerate(captions)]
    return scorer.compute_score(gts, res)[1]


@pytest.fixture(scope="module")
def refs():
    return make_refs()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_scores_match_reference_and_python_scorer(refs, seed):
    video_ids = list(refs)
    caps = hypotheses(refs, seed)
    ours = native.NativeCiderD(refs).score_strings(video_ids, caps)
    theirs = ref_native.NativeCiderD(refs).score_strings(video_ids, caps)
    df, n = build_corpus_df(refs)
    py = python_scores(CiderD(df_mode="corpus", df=df, ref_len=float(n)),
                       refs, video_ids, caps)
    np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours, py, rtol=RTOL, atol=ATOL)
    assert ours.max() > 1.0          # the rows that are references


def test_score_ids_equals_score_strings(refs):
    vocab = Vocab({i + 1: w for i, w in enumerate(WORDS)})
    scorer = native.NativeCiderD(refs, vocab.word_to_ix)
    video_ids = list(refs)[:4]
    caps = [refs[v][1] for v in video_ids]
    ids = np.stack([vocab.encode(c.split(), 12) for c in caps])
    np.testing.assert_allclose(scorer.score_ids(video_ids, ids),
                               scorer.score_strings(video_ids, caps),
                               rtol=RTOL, atol=ATOL)


def test_score_ids_refuses_rows_not_grouped_per_video(refs):
    scorer = native.NativeCiderD(refs)
    with pytest.raises(ValueError, match="multiple"):
        scorer.score_ids(list(refs)[:4], np.zeros((10, 4), np.int32))
    with pytest.raises(KeyError):
        scorer.score_ids(["nope"], np.zeros((1, 4), np.int32))


def test_load_df_matches_reference(refs):
    """An external df over a larger corpus replaces the one built from
    the references, in both packages alike, and changes the scores."""
    df, ndocs = build_corpus_df({**refs, **make_refs(25, seed=9)})
    video_ids = list(refs)[:4]
    rng = np.random.default_rng(5)
    caps = [" ".join(rng.choice(WORDS, int(rng.integers(3, 9))))
            for _ in range(8)]
    ours = native.NativeCiderD(refs)
    ours.load_df(df, float(ndocs))
    theirs = ref_native.NativeCiderD(refs)
    theirs.load_df(df, float(ndocs))
    got = ours.score_strings(video_ids, caps)
    np.testing.assert_allclose(got, theirs.score_strings(video_ids, caps),
                               rtol=RTOL, atol=ATOL)
    internal = native.NativeCiderD(refs).score_strings(video_ids, caps)
    assert not np.allclose(got, internal)
    assert [native.fnv_ngram_hash(g) for g in ([1], [3, 7], [2, 2, 9])] == \
        [ref_native.fnv_ngram_hash(g) for g in ([1], [3, 7], [2, 2, 9])]


@pytest.mark.parametrize("corpus", ["random", "single-caption"])
def test_consensus_scores_match_reference(refs, corpus):
    if corpus == "single-caption":
        refs = {"v0": ["a man is cooking"], "v1": ["a dog runs", "dog runs"]}
    ours = native.NativeCiderD(refs).consensus_scores()
    theirs = ref_native.NativeCiderD(refs).consensus_scores()
    python = jax_consensus(refs, native=False)
    assert set(ours) == set(theirs) == set(python)
    for vid in ours:
        np.testing.assert_allclose(ours[vid], theirs[vid], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(ours[vid], python[vid], rtol=RTOL,
                                   atol=ATOL)


GOLDEN = [
    "A man is cooking.", "don't run!", "DON'T RUN!!", "cannot.", "gonna",
    "'tis gonna rain", "'twas the night", "the dog... ran (fast)",
    "it's the dogs' ball", "u.s. army", "e.g. a dog", "...", "--", "''",
    "a-b c--d e---f", "he said \"hello there\" loudly",
    "score: 3/4 (75%)", "x's y're z've w'll v'm u'd tn't",
    "'quoted' ''double'' '''triple'''", "trailing. .leading .both.",
    "A.B.C.", "[brackets] {braces} <angles>", "multi   spaces\tand\nnewlines",
    "", "   ", "!!!???",
]


def _fuzz(seed, n=400):
    rng = random.Random(seed)
    alphabet = (string.ascii_letters + string.digits
                + " .',!?-()\"'&%$#@\t\n")
    return ["".join(rng.choices(alphabet, k=rng.randint(0, 60)))
            for _ in range(n)]


@pytest.mark.parametrize("corpus", ["golden", "fuzz0", "fuzz1"])
def test_ptb_tokenize_batch_matches_reference(corpus):
    caps = GOLDEN if corpus == "golden" else _fuzz(int(corpus[-1]))
    ours = native.ptb_tokenize_batch(caps)
    assert ours == ref_native.ptb_tokenize_batch(caps)
    assert ours == [tokenizer.tokenize_to_str(c) for c in caps]


def test_tokenize_corpus_native_equals_python():
    """The corpus path sends the ASCII captions to C++ in one batch and
    the rest through Python; the result equals the Python path's."""
    corpus = {f"v{i}": GOLDEN[i::4] + ["un café crème."] for i in range(4)}
    assert tokenizer._resolve_native() is native.ptb_tokenize_batch
    assert tokenizer.tokenize_corpus(corpus) == {
        k: [tokenizer.tokenize_to_str(c) for c in caps]
        for k, caps in corpus.items()}
    with pytest.raises(ValueError, match="ASCII"):
        native.ptb_tokenize_batch(["un café"])


@pytest.mark.parametrize("baseline", ["greedy", "scb-sample"])
def test_reward_computer_on_native_scorer_matches_reference(refs,
                                                            baseline):
    ix_to_word = {i + 1: w for i, w in enumerate(WORDS)}
    ours = RewardComputer(
        Vocab(ix_to_word),
        native.NativeCiderD(refs, Vocab(ix_to_word).word_to_ix), refs,
        seq_per_img=2, baseline=baseline)
    theirs = JaxRewardComputer(
        JaxVocab(ix_to_word),
        ref_native.NativeCiderD(refs, JaxVocab(ix_to_word).word_to_ix),
        refs, seq_per_img=2, baseline=baseline)
    df, n = build_corpus_df(refs)
    python = JaxRewardComputer(
        JaxVocab(ix_to_word), JaxCiderD(df_mode="corpus", df=df,
                                         ref_len=float(n)),
        refs, seq_per_img=2, baseline=baseline)
    assert ours._native and theirs._native and not python._native
    rng = np.random.default_rng(3)
    video_ids = list(refs)[:3]
    sampled = np.zeros((6, 10), dtype=np.int32)
    for i in range(6):
        k = int(rng.integers(2, 9))
        sampled[i, :k] = rng.integers(1, len(WORDS) + 1, k)
    greedy = sampled[::2].copy() if baseline == "greedy" else None
    adv, stats = ours(video_ids, sampled, greedy)
    for other in (theirs, python):
        want, want_stats = other(video_ids, sampled, greedy)
        np.testing.assert_allclose(adv, want, rtol=1e-5, atol=1e-7)
        assert stats["reward"] == pytest.approx(want_stats["reward"],
                                                rel=1e-6)


def test_library_builds_into_the_build_dir_and_rebuilds_on_edit(tmp_path):
    assert native.library_path(native.CIDERD_SRC).parent == \
        native.BUILD_DIR
    assert native.BUILD_DIR.name == "build" and \
        native.BUILD_DIR.parent.name == "cst_captioning_tpu_torch"
    src = tmp_path / "ciderd.cpp"
    shutil.copy(native.CIDERD_SRC, src)
    out = tmp_path / "build"
    first = native.build_library(src, out)
    assert first.exists() and first.parent == out
    assert first.name.startswith("libciderd-") and first.suffix == ".so"
    assert native.build_library(src, out) == first       # cached
    src.write_text(src.read_text() + "\n// edited\n")
    second = native.build_library(src, out)
    assert second != first and second.exists()
    assert sorted(p.name for p in out.iterdir()) == sorted(
        [first.name, second.name])              # no temporary left
    assert sorted(p.name for p in tmp_path.iterdir()) == ["build",
                                                          "ciderd.cpp"]


def test_digest_covers_the_compiler_and_the_platform(monkeypatch):
    """A library built by another g++, or for another platform or C
    library, has another path: it is rebuilt, never loaded."""
    base = native.library_path(native.CIDERD_SRC)
    assert native.toolchain_id().startswith("g++ ")
    monkeypatch.setattr(native, "_gxx_version", lambda gxx: "0.0.1")
    other_gxx = native.library_path(native.CIDERD_SRC)
    monkeypatch.setattr(native.sysconfig, "get_platform",
                        lambda: "linux-aarch64")
    other_platform = native.library_path(native.CIDERD_SRC)
    assert len({base, other_gxx, other_platform}) == 3
    assert {p.parent for p in (base, other_gxx, other_platform)} == {
        native.BUILD_DIR}


def test_no_compiler_raises_native_unavailable(tmp_path, monkeypatch):
    src = tmp_path / "tokenizer.cpp"
    shutil.copy(native.TOKENIZER_SRC, src)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(native.NativeUnavailable, match="g\\+\\+"):
        native.build_library(src, tmp_path / "build")
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").iterdir())


TINY = ["--device", "cpu", "--synthetic_videos", "8",
        "--synthetic_val_videos", "4", "--captions_per_video", "5",
        "--feat_shapes", "4x8,1x5", "--rnn_size", "16",
        "--input_encoding_size", "16", "--att_size", "16",
        "--batch_size", "4", "--seq_per_img", "5", "--max_length", "8",
        "--max_epochs", "1", "--use_rl", "1", "--device_rewards", "0"]


@pytest.mark.parametrize("flag,want", [("1", "native"), ("0", "python")])
def test_trainer_host_path_scorer(tmp_path, flag, want):
    trainer = Trainer(train.parse_args(
        TINY + ["--native_cider", flag, "--checkpoint_path",
                str(tmp_path)]))
    try:
        assert trainer.cst_scorer == want
        assert isinstance(trainer.reward_computer.scorer,
                          native.NativeCiderD if want == "native"
                          else CiderD)
        assert trainer.registry.snapshot()["info"]["cst_scorer"] == want
        done = [len(trainer.iteration()) for _ in range(3)]
        assert done == [0, 0, 1]
    finally:
        trainer.close()


def test_trainer_falls_back_to_python_without_the_library(tmp_path,
                                                          monkeypatch,
                                                          caplog):
    """As the reference's trainer: a library that cannot be built is a
    warning and the Python scorer, never a failed run."""
    def unavailable(*a, **k):
        raise native.NativeUnavailable("g++ not available")

    from cst_captioning_tpu_torch.training import rewards

    monkeypatch.setattr(rewards, "NativeCiderD", unavailable)
    trainer = Trainer(train.parse_args(TINY + ["--checkpoint_path",
                                               str(tmp_path)]))
    try:
        assert trainer.cst_scorer == "python"
        assert any("native CIDEr-D unavailable" in r.message
                   for r in caplog.records)
    finally:
        trainer.close()
