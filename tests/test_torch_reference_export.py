"""The port from the reference's files and checkpoints, on the CPU:
``--train_cached_tokens`` (the on-device CIDEr-D tables from an external
df equal to the reference's tables and its rewards within 1e-4 of the
reference's; the native host scorer with that df within rtol 1e-9 of the
Python one); a reference checkpoint saved through its
``CheckpointManager`` and exported by ``export_for_torch.py checkpoint``
in a process of its own, decoded by the port (greedy and beam-3 tokens
identical to the reference's decode, teacher-forced logits within
1e-5 * max(1, max|x|)), through the eval and serve CLIs on exported
``--test_*`` files, and as ``--start_from`` (the model at its saved
widths, its weights loaded); and the train CLI from written files: XE, WXE from
the consensus pickle and CST scb-gt with ``--train_cached_tokens``, each
bit-identical to the same run on the in-memory split, then the eval CLI
on ``--test_*`` files equal to the checkpoint's own val split, and an
exported checkpoint of the port's own weights served caption for
caption as the eval decodes it.
"""

import io
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
from cst_captioning_tpu.metrics.ciderd import save_corpus_df as jsave_df
from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu.ops import jax_ciderd
from cst_captioning_tpu.ops.beam import beam_search as jax_beam_search
from cst_captioning_tpu.ops.sampling import greedy_decode as jax_greedy
from cst_captioning_tpu.training import device_rewards as jax_tables
from cst_captioning_tpu.training.checkpoint import (
    CheckpointManager as JaxCheckpointManager)
from cst_captioning_tpu.training.evaluation import eval_split as jax_eval
from cst_captioning_tpu.training.state import (create_train_state,
                                               make_optimizer)
from cst_captioning_tpu_torch import eval as port_eval
from cst_captioning_tpu_torch import serve, train
from cst_captioning_tpu_torch.data import synthetic
from cst_captioning_tpu_torch.data.vocab import Vocab
from cst_captioning_tpu_torch.metrics.ciderd import (build_corpus_df,
                                                     load_corpus_df)
from cst_captioning_tpu_torch.ops import device_ciderd
from cst_captioning_tpu_torch.ops.beam import beam_search
from cst_captioning_tpu_torch.ops.sampling import greedy_decode
from cst_captioning_tpu_torch.serving.buckets import parse_buckets
from cst_captioning_tpu_torch.serving.engine import ServingEngine
from cst_captioning_tpu_torch.serving.server import CaptionServer
from cst_captioning_tpu_torch.tools.stage_chain import data_argv
from cst_captioning_tpu_torch.training import checkpoint, device_rewards
from cst_captioning_tpu_torch.training.rewards import (RewardComputer,
                                                       host_scorer)
from cst_captioning_tpu_torch.training.trainer import Trainer
from cst_captioning_tpu_torch.weights import (from_flax,
                                              load_exported_checkpoint,
                                              model_from_flax,
                                              save_exported_checkpoint,
                                              to_flax)

REPO = Path(__file__).resolve().parent.parent
WORDS = [f"w{i}" for i in range(30)]
W2I = {w: i + 1 for i, w in enumerate(WORDS)}


def _refs(n, seed, oov=()):
    rng = np.random.default_rng(seed)
    pool = WORDS + list(oov)
    return {f"v{v}": [" ".join(rng.choice(pool, int(rng.integers(2, 9))))
                      for _ in range(int(rng.integers(2, 6)))]
            for v in range(n)}


def _rows(refs, n, seed, length=10):
    rng = np.random.default_rng(seed)
    vids = list(refs)
    video_ix = rng.integers(0, len(vids), n)
    rows = np.zeros((n, length), np.int64)
    for i, v in enumerate(video_ix):
        src = (refs[vids[v]][0].split() if i % 3 == 0
               else rng.choice(WORDS, int(rng.integers(1, length))))
        ids = [W2I[w] for w in src if w in W2I][:length]
        rows[i, :len(ids)] = ids
    return rows, video_ix


# -- 5. --train_cached_tokens ------------------------------------------------

@pytest.fixture(scope="module")
def cached_df(tmp_path_factory):
    """A df pickle over a larger corpus (with words outside the
    vocabulary), written by the reference, read by the port."""
    refs = _refs(8, 1, oov=("x0", "x1"))
    corpus = {**refs, **_refs(20, 7, oov=("x2", "x3"))}
    path = tmp_path_factory.mktemp("df") / "train_ciderdf.pkl"
    jsave_df(str(path), *build_corpus_df(corpus))
    return refs, str(path)


def test_device_tables_from_external_df_equal_the_reference(cached_df):
    refs, path = cached_df
    df, ref_len = load_corpus_df(path)
    jc, jt, _ = jax_tables.build_device_tables(
        refs, W2I, external_df=df, external_ref_len=ref_len)
    tc, tt, _ = device_rewards.build_device_tables(
        refs, W2I, external_df=df, external_ref_len=ref_len)
    for name in jc._fields:
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)), name)
    for name in jt._fields:
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)), name)
    rows, vix = _rows(refs, 24, 3)
    want = np.asarray(jax.jit(jax_ciderd.ciderd_scores)(
        rows.astype(np.int32), vix.astype(np.int32), jc, jt))
    got = device_ciderd.ciderd_scores(torch.from_numpy(rows),
                                      torch.from_numpy(vix), tc, tt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    own = device_ciderd.ciderd_scores(
        torch.from_numpy(rows), torch.from_numpy(vix),
        *device_rewards.build_device_tables(refs, W2I)[:2]).numpy()
    assert not np.allclose(got, own), "the external df changes no score"
    with pytest.raises(ValueError, match="ref_len"):
        device_rewards.build_device_tables(refs, W2I, external_df=df)


def test_native_with_cached_df_equals_python(cached_df):
    refs, path = cached_df
    corpus_df = load_corpus_df(path)
    vocab = Vocab({i: w for w, i in W2I.items()})
    rows, vix = _rows(refs, 24, 4)
    vids = list(refs)
    video_ids = [vids[v] for v in vix]
    scores = {}
    for native in (True, False):
        scorer, kind = host_scorer(refs, W2I, native=native,
                                   corpus_df=corpus_df)
        assert kind == ("native" if native else "python")
        rc = RewardComputer(vocab, scorer, refs, seq_per_img=1)
        scores[kind] = rc._reward(video_ids, rows)
    np.testing.assert_allclose(scores["native"], scores["python"],
                               rtol=1e-9, atol=1e-12)
    tables = device_rewards.build_device_tables(
        refs, W2I, external_df=corpus_df[0], external_ref_len=corpus_df[1])
    dev = device_ciderd.ciderd_scores(torch.from_numpy(rows),
                                      torch.from_numpy(vix),
                                      *tables[:2]).numpy()
    np.testing.assert_allclose(dev, scores["python"], rtol=1e-4, atol=1e-5)


def test_bad_df_pickle_fails(tmp_path):
    bad = tmp_path / "bad.pkl"
    bad.write_bytes(b"not a pickle")
    with pytest.raises(Exception):
        load_corpus_df(str(bad))
    import pickle
    bad.write_bytes(pickle.dumps({"nope": 1}))
    with pytest.raises(ValueError, match="corpus-df"):
        load_corpus_df(str(bad))


# -- 6. a reference checkpoint, exported ------------------------------------

SPEC = dict(num_videos=8, captions_per_video=5, max_len=8, feat_dims=(8, 5),
            feat_times=(3, 1), seed=0)


@pytest.fixture(scope="module")
def reference_checkpoint(tmp_path_factory):
    """A reference model saved through the reference's
    ``CheckpointManager`` (two steps; the best is exported), its val split
    on HDF5 exported as the port's files, and the checkpoint exported by
    ``export_for_torch.py checkpoint`` in its own process."""
    root = tmp_path_factory.mktemp("ref_ck")
    train_paths = jsynthetic.generate(str(root), "train",
                                      jsynthetic.SyntheticSpec(**SPEC))
    with JaxDataset(jsynthetic.split_paths(train_paths)) as ds:
        vocab = ds.vocab
    jsynthetic.generate(str(root), "val", jsynthetic.SyntheticSpec(
        **dict(SPEC, num_videos=6)), vocab=vocab)
    jm = JaxCaptionModel(vocab_size=vocab.size_with_pad, embed_size=16,
                         hidden_size=16, attn_size=16, dropout_rate=0.0)
    tx, _ = make_optimizer()
    states = [create_train_state(jm, jax.random.PRNGKey(k), [(3, 8), (1, 5)],
                                 8, 1, tx) for k in (5, 3)]
    mgr = JaxCheckpointManager(str(root / "ck"), max_to_keep=2)
    for step, (state, score) in enumerate(zip(states, (2.0, 1.0))):
        mgr.save(step + 1, state, score=score, extra={"opt": {
            "rnn_size": 16, "input_encoding_size": 16, "att_size": 16,
            "max_length": 8, "use_bfloat16": 0, "model_type": "lstm",
            "train_info_json": train_paths["info_json"]}})
    mgr.close()
    out = root / "export"
    import export_for_torch
    for split in ("train", "val"):
        export_for_torch.export_data(str(root), split, str(out / "data"))
    proc = subprocess.run(
        [sys.executable, str(REPO / "export_for_torch.py"), "checkpoint",
         "--checkpoint_path", str(root / "ck"), "--out_dir",
         str(out / "ck")], capture_output=True, text=True, timeout=240,
        cwd=REPO, env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
                       "HOME": str(root)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    params = jax.tree_util.tree_map(np.asarray, states[0].params)
    return {"jm": jm, "params": params, "root": root, "out": out,
            "export": json.loads(proc.stdout.strip().splitlines()[-1])}


def test_exported_checkpoint_decodes_as_the_reference(reference_checkpoint):
    rc = reference_checkpoint
    params, opts, vocab = load_exported_checkpoint(str(rc["out"] / "ck"))
    assert rc["export"]["step"] == 1 and opts["rnn_size"] == 16
    model = model_from_flax(params, device="cpu", decode_kernel="fused")
    rng = np.random.default_rng(2)
    feats = [(rng.normal(size=(5,) + s) * 2).astype(np.float32)
             for s in ((3, 8), (1, 5))]
    labels = rng.integers(1, vocab.size_with_pad, (5, 8)).astype(np.int32)
    variables = {"params": rc["params"]}
    jfeats = [jnp.asarray(f) for f in feats]
    tfeats = [torch.from_numpy(f) for f in feats]
    want = np.asarray(rc["jm"].apply(variables, jfeats, labels, train=False))
    with torch.no_grad():
        got = model(tfeats, torch.from_numpy(labels).long()).numpy()
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())
    np.testing.assert_array_equal(
        greedy_decode(model, tfeats, 8).numpy(),
        np.asarray(jax_greedy(rc["jm"], variables, jfeats, 8)))
    best_j, beams_j, _ = jax_beam_search(rc["jm"], variables, jfeats,
                                         beam_size=3, max_len=8)
    best, beams, _ = beam_search(model, tfeats, 3, 8)
    np.testing.assert_array_equal(best.numpy(), np.asarray(best_j))
    np.testing.assert_array_equal(beams.numpy(), np.asarray(beams_j))


def test_exported_checkpoint_through_eval_and_serve(reference_checkpoint,
                                                    tmp_path):
    rc = reference_checkpoint
    test = data_argv(str(rc["out"] / "data"), "val", "test")
    result = tmp_path / "r.json"
    assert port_eval.main(["--checkpoint_path", str(rc["out"] / "ck"),
                           "--beam_size", "3", "--batch_size", "4",
                           "--decode_kernel", "fused", "--device", "cpu",
                           "--result_file", str(result), *test]) == 0
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
    want = {p["image_id"]: p["caption"] for p in preds}
    assert _served(["--checkpoint_path", str(rc["out"] / "ck"),
                    "--beam_size", "3", "--device", "cpu", *test],
                   want) == want
    with pytest.raises(ValueError, match="--test_"):
        port_eval.main(["--checkpoint_path", str(rc["out"] / "ck"),
                        "--device", "cpu"])


def _served(argv, want):
    opt = serve.parse_args(argv)
    model, vocab, shapes, feats_for = serve.build_backend(opt)
    assert feats_for("nope") is None
    engine = ServingEngine(model, shapes, max_len=opt.max_length,
                           beam_size=opt.beam_size,
                           decode_chunk=opt.decode_chunk,
                           bucket_sizes=parse_buckets(opt.serve_buckets))
    out = io.StringIO()
    lines = [json.dumps({"id": i, "video_id": v}) + "\n"
             for i, v in enumerate(want)]
    assert CaptionServer(engine, vocab, feats_for, out=out).run_stdin(
        lines=lines) == 0
    return {r["video_id"]: r["caption"]
            for r in map(json.loads, out.getvalue().splitlines())}


def test_start_from_exported_takes_its_widths_and_weights(
        reference_checkpoint, tmp_path):
    """``--start_from`` an exported checkpoint builds the model at the
    widths of its saved options (the CLI's defaults are 512) and loads
    its weights."""
    rc = reference_checkpoint
    data = str(rc["out"] / "data")
    trainer = Trainer(train.parse_args(
        data_argv(data, "train") + data_argv(data, "val")
        + ["--start_from", str(rc["out"] / "ck"), "--batch_size", "4",
           "--seq_per_img", "5", "--max_length", "8", "--device", "cpu",
           "--checkpoint_path", str(tmp_path / "ck")]))
    try:
        assert trainer.opt.rnn_size == 16 and trainer.opt.att_size == 16
        want = from_flax(rc["params"])
        got = trainer.model.state_dict()
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    finally:
        trainer.close()


def test_exported_digest_mismatch_raises(reference_checkpoint, tmp_path):
    import shutil
    bad = tmp_path / "ck"
    shutil.copytree(reference_checkpoint["out"] / "ck", bad)
    (bad / "vocab.json").write_text('{"ix_to_word": {"1": "a"}}')
    with pytest.raises(ValueError, match="digest"):
        load_exported_checkpoint(str(bad))


# -- 7. the train CLI from written files ------------------------------------

SMALL = ["--rnn_size", "16", "--input_encoding_size", "16", "--att_size",
         "16", "--max_length", "8", "--batch_size", "4", "--seq_per_img",
         "5", "--max_epochs", "1", "--log_every", "1", "--fast_val", "1",
         "--device", "cpu", "--decode_kernel", "fused", "--pallas_attention",
         "1"]
SYNTH = ["--synthetic_videos", "9", "--synthetic_val_videos", "5",
         "--captions_per_video", "5", "--feat_shapes", "3x8,1x5",
         "--synthetic_seed", "1"]


def _run(argv, capsys):
    assert train.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


#: Keys of a metrics.jsonl record that are clock readings.
CLOCK_KEYS = ("time", "captions_per_sec")


def _records(ck):
    """Every record of the stage's metrics.jsonl, clock readings
    dropped."""
    return [{k: v for k, v in json.loads(line).items()
             if k not in CLOCK_KEYS}
            for line in (Path(ck) / "metrics.jsonl").read_text()
            .splitlines()]


def _assert_same_run(a, b):
    """Two stage directories hold the same run: the parameters of the
    last step equal bit for bit, every train and val record equal."""
    sa, sb = checkpoint.load(str(a)), checkpoint.load(str(b))
    assert sa["step"] == sb["step"] == 2
    for k in sa["model"]:
        assert torch.equal(sa["model"][k], sb["model"][k]), k
    ra, rb = _records(a), _records(b)
    assert [r["scope"] for r in ra] == ["train", "train", "val"]
    assert ra == rb


def test_train_eval_serve_from_files_equal_the_in_memory_split(tmp_path,
                                                               capsys):
    spec = synthetic.SyntheticSpec(num_videos=9, captions_per_video=5,
                                   max_len=8, feat_dims=(8, 5),
                                   feat_times=(3, 1), seed=1)
    data = tmp_path / "data"
    train_split = synthetic.write_split(str(data), "train", spec)
    synthetic.write_split(
        str(data), "val", synthetic.SyntheticSpec(**{**spec.__dict__,
                                                     "num_videos": 5}),
        vocab=Vocab.from_json(json.loads(Path(
            train_split["vocab_json"]).read_text())["ix_to_word"]))
    files = data_argv(str(data), "train") + data_argv(str(data), "val")
    assert "--train_cached_tokens" in files and "--val_feat_npy" in files
    ck = tmp_path / "ck"
    stages = {
        "xe": [],
        "wxe": ["--use_consensus_weights", "1", "--consensus_temperature",
                "0.5", "--start_from", "{}/xe"],
        "cst": ["--use_rl", "1", "--rl_baseline", "scb-gt",
                "--start_from", "{}/wxe"],
    }
    for name, extra in stages.items():
        for kind, data_flags in (("files", files), ("memory", SYNTH)):
            base = str(ck / kind)
            argv = SMALL + [a.format(base) for a in extra] + [
                "--checkpoint_path", f"{base}/{name}"]
            _run(argv + data_flags, capsys)
        _assert_same_run(ck / "files" / name, ck / "memory" / name)

    # eval on --test_* files equals eval on the checkpoint's own val split
    evals = {}
    for kind, extra in (("files", data_argv(str(data), "val", "test")),
                        ("own", [])):
        result = tmp_path / f"{kind}.json"
        assert port_eval.main(["--checkpoint_path", str(ck / "files/cst"),
                               "--beam_size", "3", "--batch_size", "4",
                               "--decode_kernel", "fused", "--device", "cpu",
                               "--result_file", str(result), *extra]) == 0
        evals[kind] = json.loads(result.read_text())
    assert evals["files"] == evals["own"]
    assert len(evals["files"]["predictions"]) == 5

    # an exported checkpoint of the port's own weights, served
    saved = checkpoint.load(str(ck / "files/cst"))
    vocab = Vocab.from_json(json.loads(Path(
        train_split["vocab_json"]).read_text())["ix_to_word"])
    save_exported_checkpoint(str(tmp_path / "exported"),
                             to_flax(saved["model"]), saved["opt"], vocab,
                             source=str(ck / "files/cst"), step=2)
    want = {p["image_id"]: p["caption"]
            for p in evals["files"]["predictions"]}
    assert _served(["--checkpoint_path", str(tmp_path / "exported"),
                    "--beam_size", "3", "--device", "cpu",
                    *data_argv(str(data), "val", "test")], want) == want
