"""The port's on-disk data path against the reference's, on the CPU:
the converters on the MSR-VTT fixture (equal annotations); the port's
prepro against the reference's (json files equal as parsed JSON, label
arrays and dtypes equal, the df pickle equal and the consensus pickles
within 1e-9: the reference scores them with its C++ scorer, the port in
Python, in another summation order); the reference's synthetic HDF5 split
through ``export_for_torch.py data`` into the port's ``CaptionDataset``
against the reference's (features bit-equal for unsorted and duplicate
indices, memory-mapped and preloaded; the same errors); the port's
loader over those files against the reference's loader over HDF5 and the
port's loader over the in-memory split (XE, and WXE weights from the
consensus pickle at temperature 0.5), batch for batch; ``write_split``
against the in-memory split; the chunked ``--device_feats`` upload;
the reference's HDF5 flags refused with exit 2; and ``stage_chain
--data_dir/--start_from``'s arguments.
"""

import json
import pickle
import shutil
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from cst_captioning_tpu.data import converters as jconverters
from cst_captioning_tpu.data import prepro as jprepro
from cst_captioning_tpu.data import synthetic as jsynthetic
from cst_captioning_tpu.data.dataset import CaptionDataset as JaxDataset
from cst_captioning_tpu.data.loader import CaptionLoader as JaxLoader
from cst_captioning_tpu.metrics.consensus import (
    load_consensus as jload_consensus)
from cst_captioning_tpu.metrics.consensus import (
    normalize_weights as jnormalize)
from cst_captioning_tpu_torch import eval as port_eval
from cst_captioning_tpu_torch import serve, train
from cst_captioning_tpu_torch.data import converters, prepro, synthetic
from cst_captioning_tpu_torch.data.dataset import (CaptionDataset,
                                                   SplitPaths, split_files)
from cst_captioning_tpu_torch.data.loader import CaptionLoader
from cst_captioning_tpu_torch.metrics.ciderd import load_corpus_df
from cst_captioning_tpu_torch.metrics.consensus import (load_consensus,
                                                        normalize_weights)
from cst_captioning_tpu_torch.tools import stage_chain
from cst_captioning_tpu_torch.training.trainer import Trainer

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import export_for_torch  # noqa: E402

SPEC = dict(num_videos=9, captions_per_video=5, max_len=8,
            feat_dims=(12, 6), feat_times=(3, 1), seed=2, rich_vocab=0)
CONSENSUS_TOL = 1e-9


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The reference's synthetic train and val splits written to HDF5,
    exported to the port's files; -> (reference dir, export dir)."""
    src = tmp_path_factory.mktemp("ref_split")
    out = tmp_path_factory.mktemp("exported")
    paths = jsynthetic.generate(str(src), "train",
                                jsynthetic.SyntheticSpec(**SPEC))
    with JaxDataset(jsynthetic.split_paths(paths)) as ds:
        vocab = ds.vocab
    jsynthetic.generate(str(src), "val", jsynthetic.SyntheticSpec(
        **dict(SPEC, num_videos=5)), vocab=vocab)
    for split in ("train", "val"):
        export_for_torch.export_data(str(src), split, str(out))
    return src, out


def split_paths(files):
    return SplitPaths(feat_npy=files["feat_npy"],
                      label_npz=files["label_npz"],
                      info_json=files["info_json"],
                      cocofmt_json=files.get("cocofmt_json"))


def _ref_paths(src, split):
    return jsynthetic.split_paths({
        "feat_h5": json.dumps([str(src / f"{split}_feat{m}.h5")
                               for m in range(2)]),
        "label_h5": str(src / f"{split}_label.h5"),
        "info_json": str(src / f"{split}_info.json"),
        "cocofmt_json": str(src / f"{split}_cocofmt.json")})


# -- 1. converters ---------------------------------------------------------

def test_converters_equal_the_reference():
    with open(REPO / "tests/fixtures/mini_videodatainfo.json") as f:
        info = json.load(f)
    assert converters.convert_msrvtt(info) == jconverters.convert_msrvtt(
        info)
    lines = [f"vid{i % 7}\tcaption {i} of clip {i % 7}" for i in range(40)]
    assert converters.convert_msvd(lines) == jconverters.convert_msvd(lines)
    splits = {"train": ["vid1", "vid2"], "test": ["vid3", "nope"]}
    assert (converters.convert_msvd(lines, splits)
            == jconverters.convert_msvd(lines, splits))
    anet = {"train": {"v_a": {"sentences": [" a b ", "c d"]}},
            "val": {"v_b": {"sentences": ["e f "]}}}
    assert (converters.convert_activitynet(anet)
            == jconverters.convert_activitynet(anet))


def test_converters_cli_writes_the_same_files(tmp_path):
    src = str(REPO / "tests/fixtures/mini_videodatainfo.json")
    ours = converters.main(["--format", "msrvtt", "--input", src,
                            "--out_prefix", str(tmp_path / "p_")])
    theirs = jconverters.main(["--format", "msrvtt", "--input", src,
                               "--out_prefix", str(tmp_path / "r_")])
    assert ours.keys() == theirs.keys()
    for split in ours:
        assert (json.loads(Path(ours[split]).read_text())
                == json.loads(Path(theirs[split]).read_text()))


# -- 2. prepro ---------------------------------------------------------------

def _assert_prepro_equal(ours, theirs):
    for key in ("vocab_json", "info_json", "cocofmt_json"):
        assert (json.loads(Path(ours[key]).read_text())
                == json.loads(Path(theirs[key]).read_text())), key
    with np.load(ours["label_npz"]) as npz, h5py.File(theirs["label_h5"],
                                                      "r") as f:
        assert sorted(npz.files) == sorted(f.keys())
        for k in npz.files:
            assert npz[k].dtype == f[k].dtype, k
            np.testing.assert_array_equal(npz[k], f[k][()])
    if "cached_tokens" not in theirs:
        assert "cached_tokens" not in ours
        return
    with open(ours["cached_tokens"], "rb") as a, \
            open(theirs["cached_tokens"], "rb") as b:
        assert pickle.load(a) == pickle.load(b)
    for key in ("consensus_pkl", "wxe_weights_pkl"):
        got, want = load_consensus(ours[key]), jload_consensus(theirs[key])
        assert got.keys() == want.keys()
        for vid in want:
            assert got[vid].dtype == np.asarray(want[vid]).dtype
            np.testing.assert_allclose(got[vid], want[vid], rtol=0,
                                       atol=CONSENSUS_TOL)


def test_prepro_equals_the_reference(tmp_path):
    with open(REPO / "tests/fixtures/mini_videodatainfo.json") as f:
        anns = jconverters.convert_msrvtt(json.load(f))
    ours = prepro.build_split(anns["train"], str(tmp_path / "p"), "train",
                              max_len=6, count_threshold=1)
    theirs = jprepro.build_split(anns["train"], str(tmp_path / "r"),
                                 "train", max_len=6, count_threshold=1)
    _assert_prepro_equal(ours, theirs)
    vocab = prepro.load_vocab(ours["vocab_json"])
    jvocab = jprepro.load_vocab(theirs["vocab_json"])
    ours = prepro.main(["--annotations", _write(tmp_path / "val.json",
                                                anns["val"]),
                        "--split", "val", "--out_dir", str(tmp_path / "p"),
                        "--max_len", "6", "--vocab_json",
                        str(tmp_path / "p/train_vocab.json"),
                        "--no_reward_artifacts"])
    theirs = jprepro.build_split(anns["val"], str(tmp_path / "r"), "val",
                                 max_len=6, vocab=jvocab,
                                 build_reward_artifacts=False)
    assert len(vocab) == len(jvocab)
    _assert_prepro_equal(ours, theirs)


def _write(path, anns):
    path.write_text(json.dumps({"videos": anns}))
    return str(path)


def test_prepro_rejects_a_video_without_captions(tmp_path):
    with pytest.raises(ValueError, match="zero captions"):
        prepro.build_split([{"id": "a", "captions": []}], str(tmp_path),
                           "train")


# -- 3. the exported split in the port's CaptionDataset --------------------

@pytest.mark.parametrize("preload", [False, True])
@pytest.mark.parametrize("split", ["train", "val"])
def test_exported_split_equals_the_reference_dataset(exported, preload,
                                                     split):
    src, out = exported
    files = split_files(str(out), split)
    with JaxDataset(_ref_paths(src, split)) as theirs, \
            CaptionDataset(split_paths(files), preload=preload) as ours:
        assert ours.video_ids == theirs.video_ids
        assert ours.vocab.to_json() == theirs.vocab.to_json()
        assert (ours.feat_dims, ours.feat_times, ours.seq_length) == (
            theirs.feat_dims, theirs.feat_times, theirs.seq_length)
        assert ours.references() == theirs.references()
        n = ours.num_videos
        for ix in (np.arange(n), np.asarray([n - 1, 0, 2, 2, 0, n - 1]),
                   np.asarray([3, 1, 1])):
            for a, b in zip(ours.features(ix), theirs.features(ix)):
                assert a.dtype == np.float32 and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
        for i in range(n):
            np.testing.assert_array_equal(ours.captions_for(i),
                                          theirs.captions_for(i))
    manifest = json.loads((out / "export.json").read_text())
    assert manifest["splits"][split]["feat_npy"] == [
        f"{split}_feat0.npy", f"{split}_feat1.npy"]
    for name, meta in manifest["files"].items():
        assert meta == {**meta, **export_for_torch.digest(str(out / name))}


def test_references_decoded_without_cocofmt(exported):
    src, out = exported
    paths = split_paths(split_files(str(out), "val"))
    paths.cocofmt_json = None
    ref = _ref_paths(src, "val")
    ref.cocofmt_json = None
    with CaptionDataset(paths) as ours, JaxDataset(ref) as theirs:
        assert ours.references() == theirs.references()


def _broken_copy(tmp_path, exported, split, edit):
    src, out = exported
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    shutil.copytree(src, ref_dir)
    shutil.copytree(out, port_dir)
    edit(ref_dir, port_dir)
    return _ref_paths(ref_dir, split), split_paths(split_files(
        str(port_dir), split))


def _drop_feature_row(ref_dir, port_dir):
    with h5py.File(ref_dir / "val_feat0.h5", "a") as f:
        feats = f["feats"][()]
        del f["feats"]
        f.create_dataset("feats", data=feats[:-1])
    np.save(port_dir / "val_feat0.npy",
            np.load(port_dir / "val_feat0.npy")[:-1])


def _empty_video(ref_dir, port_dir):
    with h5py.File(ref_dir / "val_label.h5", "a") as f:
        end = f["label_end_ix"][()]
        end[1] = f["label_start_ix"][1]
        f["label_end_ix"][...] = end
    with np.load(port_dir / "val_label.npz") as npz:
        arrays = dict(npz)
    arrays["label_end_ix"][1] = arrays["label_start_ix"][1]
    np.savez(port_dir / "val_label.npz", **arrays)


@pytest.mark.parametrize("edit,match", [
    (_drop_feature_row, "feature rows != 5 videos"),
    (_empty_video, "videos with zero captions")])
def test_same_errors_as_the_reference(tmp_path, exported, edit, match):
    ref, ours = _broken_copy(tmp_path, exported, "val", edit)
    with pytest.raises(ValueError, match=match) as want:
        JaxDataset(ref)
    with pytest.raises(ValueError, match=match) as got:
        CaptionDataset(ours)
    assert str(got.value).split(": ", 1)[-1] == \
        str(want.value).split(": ", 1)[-1]


# -- 4. loader streams over files ------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_loader_stream_over_files_equals_reference_and_memory(exported,
                                                              weighted):
    src, out = exported
    files = split_files(str(out), "train")
    weights = jweights = None
    if weighted:
        weights = normalize_weights(load_consensus(files["consensus_pkl"]),
                                    temperature=0.5)
        jweights = jnormalize(jload_consensus(files["consensus_pkl"]),
                              temperature=0.5)
    memory = synthetic.generate("train", synthetic.SyntheticSpec(**SPEC))
    with CaptionDataset(split_paths(files)) as ds, \
            JaxDataset(_ref_paths(src, "train")) as jds:
        loaders = (CaptionLoader(ds, 2, seq_per_img=3, seed=7,
                                 consensus_weights=weights),
                   JaxLoader(jds, 2, seq_per_img=3, seed=7,
                             consensus_weights=jweights),
                   CaptionLoader(memory, 2, seq_per_img=3, seed=7,
                                 consensus_weights=weights))
        for _ in range(11):                      # across epoch boundaries
            a, b, c = (ld.next_batch() for ld in loaders)
            for other in (b, c):
                np.testing.assert_array_equal(a.video_ix, other.video_ix)
                np.testing.assert_array_equal(a.labels, other.labels)
                np.testing.assert_array_equal(a.weights, other.weights)
                assert a.video_ids == other.video_ids
                for fa, fb in zip(a.feats, other.feats):
                    np.testing.assert_array_equal(fa, fb)
            if weighted:
                assert not np.all(a.weights == 1.0)


# -- write_split, the chunked upload, the CLI flags -------------------------

def test_write_split_equals_the_in_memory_split(tmp_path):
    spec = synthetic.SyntheticSpec(**SPEC)
    paths = synthetic.write_split(str(tmp_path), "train", spec)
    memory = synthetic.generate("train", spec)
    consensus = load_consensus(paths["consensus_pkl"])
    with CaptionDataset(split_paths(paths)) as ds:
        np.testing.assert_array_equal(ds.labels, memory.labels)
        np.testing.assert_array_equal(ds.label_start, memory.label_start)
        np.testing.assert_array_equal(ds.label_end, memory.label_end)
        assert ds.refs == memory.refs
        assert ds.vocab.to_json() == memory.vocab.to_json()
        ix = np.asarray([4, 0, 4, 8])
        for a, b in zip(ds.features(ix), memory.features(ix)):
            np.testing.assert_array_equal(a, b)
        for vid, s in memory.consensus.items():
            np.testing.assert_array_equal(consensus[vid], s)
    assert np.load(paths["feat_npy"][1]).shape == (9, 6)    # pooled: (N, D)
    df, ndocs = load_corpus_df(paths["cached_tokens"])
    assert ndocs == 9.0 and all(len(g) <= 4 for g in df)


def test_device_feats_upload_in_chunks_equals_the_table(tmp_path, exported):
    _, out = exported
    base = train.parse_args(
        stage_chain.data_argv(str(out), "train")
        + stage_chain.data_argv(str(out), "val")
        + ["--rnn_size", "8", "--input_encoding_size", "8", "--att_size",
           "8", "--batch_size", "2", "--seq_per_img", "3", "--max_length",
           "8", "--device", "cpu", "--device_feats", "1",
           "--device_feats_upload_mb", "0.0002",
           "--checkpoint_path", str(tmp_path / "ck")])
    trainer = Trainer(base)
    try:
        ds = trainer.train_split
        assert isinstance(ds, CaptionDataset)
        full = ds.features(np.arange(ds.num_videos))
        assert len(trainer.feat_tables) == 2
        for table, want in zip(trainer.feat_tables, full):
            assert table.dtype == torch.float32
            assert torch.equal(table, torch.from_numpy(want))
    finally:
        trainer.close()


@pytest.mark.parametrize("flag", ["--train_feat_h5", "--val_label_h5",
                                  "--test_feat_h5=x.h5"])
def test_reference_h5_flags_exit_2_naming_the_exporter(flag, capsys):
    for parse in (train.parse_args, port_eval.parse_args, serve.parse_args):
        with pytest.raises(SystemExit) as e:
            parse([flag, "x.h5", "--checkpoint_path", "ck"])
        assert e.value.code == 2
        assert "export_for_torch.py data" in capsys.readouterr().err


def test_split_files_require_feature_files(tmp_path):
    with pytest.raises(FileNotFoundError, match="train_feat0.npy"):
        split_files(str(tmp_path), "train")
    with pytest.raises(ValueError, match="go together"):
        Trainer(train.parse_args(["--train_feat_npy", "a.npy",
                                  "--device", "cpu", "--checkpoint_path",
                                  str(tmp_path / "ck")]))


def test_stage_chain_on_files_and_an_exported_start(exported):
    _, out = exported
    stages = stage_chain.stage_argv("runs", data_dir=str(out),
                                    start_from="export/wxe")
    for name, argv in stages.items():
        assert "--synthetic_videos" not in argv
        opt = train.parse_args(argv)
        assert opt.train_feat_npy == [str(out / "train_feat0.npy"),
                                      str(out / "train_feat1.npy")]
        assert opt.val_label_npz == str(out / "val_label.npz")
        assert opt.train_cached_tokens == str(out / "train_ciderdf.pkl")
        assert opt.train_bcmrscores_pkl == str(out / "train_consensus.pkl")
    assert train.parse_args(stages["cst"]).start_from == "export/wxe"
    assert train.parse_args(stages["wxe"]).start_from == "runs/checkpoints/xe"
    test = port_eval.parse_args(["--checkpoint_path", "ck"] + stage_chain
                                .data_argv(str(out), "val", "test"))
    assert test.test_info_json == str(out / "val_info.json")
    assert stage_chain.data_argv(str(out), "val", "test").count(
        "--train_cached_tokens") == 0
