"""The port's training-resilience layer against the reference's, and its
behaviour through the port's ``Trainer`` on the CPU.

Parity with the JAX package on the same inputs: the exit-code table
(``classify``, ``describe``, ``normalize``), the fault-plan grammar (the
same specs for the same strings, the same errors for malformed ones),
the step manifests (each package's verifier accepts the other's, and both
catch a truncation, a bit flip and a missing file alike), the loader's
``skip_batches`` on the same split and seed, the negative-advantage
detector on the same metric sequences, and the trimming of scored and
recovery steps (the reference's orbax manager driven with the same steps
and scores).  Then, in-process at a tiny size: a torn newest checkpoint
is quarantined and the run resumes from the step before it; a stage that
stopped early does nothing when run again; ``--start_from`` reads the
best verified step; the preemption handler, the watchdog and the metrics
registry.
"""

import json
import os
import signal
import threading
import time
from types import SimpleNamespace

import flax.struct
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.data import synthetic as jsynthetic
from cst_captioning_tpu.data.dataset import CaptionDataset
from cst_captioning_tpu.data.loader import CaptionLoader as JaxLoader
from cst_captioning_tpu.resilience import exitcodes as ref_exitcodes
from cst_captioning_tpu.resilience import integrity as ref_integrity
from cst_captioning_tpu.resilience.faults import FaultPlan as RefFaultPlan
from cst_captioning_tpu.training.checkpoint import \
    CheckpointManager as RefCheckpointManager
from cst_captioning_tpu.training.trainer import \
    NegativeAdvantageAbort as RefNegativeAdvantageAbort
from cst_captioning_tpu.training.trainer import Trainer as RefTrainer
from cst_captioning_tpu_torch import train
from cst_captioning_tpu_torch.data import synthetic
from cst_captioning_tpu_torch.data.loader import CaptionLoader
from cst_captioning_tpu_torch.resilience import exitcodes, integrity
from cst_captioning_tpu_torch.resilience.faults import FaultPlan
from cst_captioning_tpu_torch.resilience.preemption import (PreemptedExit,
                                                            PreemptionHandler)
from cst_captioning_tpu_torch.telemetry.registry import (JsonlSink,
                                                         MetricsRegistry)
from cst_captioning_tpu_torch.training import checkpoint
from cst_captioning_tpu_torch.training.trainer import (NegativeAdvantageAbort,
                                                       Trainer)
from cst_captioning_tpu_torch.utils.watchdog import ProgressWatchdog

# -- exit codes --------------------------------------------------------------

CODES = sorted(ref_exitcodes.CODES) + [-15, -9, 140, 3, 200]


def test_exit_code_table_equals_reference():
    assert exitcodes.CODES == ref_exitcodes.CODES
    for name in ("EXIT_OK", "EXIT_FAILURE", "EXIT_USAGE",
                 "EXIT_ADVANTAGE_ABORT", "EXIT_PREEMPTED", "EXIT_WEDGE",
                 "EXIT_SIGINT", "EXIT_SIGKILL", "EXIT_SIGTERM"):
        assert getattr(exitcodes, name) == getattr(ref_exitcodes, name)


@pytest.mark.parametrize("rc", CODES)
def test_exit_code_classify_and_describe_equal_reference(rc):
    assert exitcodes.normalize(rc) == ref_exitcodes.normalize(rc)
    assert exitcodes.classify(rc) == ref_exitcodes.classify(rc)
    assert exitcodes.describe(rc) == ref_exitcodes.describe(rc)


# -- fault plans -------------------------------------------------------------

GOOD_PLANS = [
    "ckpt_torn@step=40,nan_grad@step=55*3,loader_err@batch=12,wedge@step=70",
    "preempt@step=1", " wedge@step=0 , preempt@step=2*2 ,",
    "serve_wedge@req=3,admit_err@req=0", "proc_kill@replica=1",
    "serve_garble@replica=0,proc_preempt@replica=2", "", "  ", None]
BAD_PLANS = ["explode@step=1", "ckpt_torn@batch=1", "nan_grad@step=x",
             "nan_grad=5", "nan_grad@stp=3", "wedge@step",
             "ckpt_torn@replica=1", "proc_kill@replica=1*2",
             "proc_kill@step=1", "preempt@step=1,bogus"]


def _specs(plan):
    return None if plan is None else [
        (s.kind, s.at, s.times, s.replica, str(s)) for s in plan.specs]


@pytest.mark.parametrize("text", GOOD_PLANS)
def test_fault_plan_parses_like_reference(text):
    mine, theirs = FaultPlan.parse(text), RefFaultPlan.parse(text)
    assert _specs(mine) == _specs(theirs)
    assert str(mine) == str(theirs)


@pytest.mark.parametrize("text", BAD_PLANS)
def test_fault_plan_rejects_like_reference(text, capsys):
    with pytest.raises(ValueError) as mine:
        FaultPlan.parse(text)
    with pytest.raises(ValueError) as theirs:
        RefFaultPlan.parse(text)
    assert str(mine.value) == str(theirs.value)
    # The train CLI refuses it as a usage error (exit 2).
    with pytest.raises(SystemExit) as e:
        train.parse_args(["--fault_plan", text])
    assert e.value.code == exitcodes.EXIT_USAGE
    assert "--fault_plan" in capsys.readouterr().err


def test_fault_plan_from_environment(monkeypatch, capsys):
    monkeypatch.setenv("CST_FAULT_PLAN", "wedge@step=7")
    assert train.parse_args([]).fault_plan == "wedge@step=7"
    monkeypatch.setenv("CST_FAULT_PLAN", "nan_grad@stp=3")
    with pytest.raises(SystemExit) as e:
        train.parse_args([])
    assert e.value.code == exitcodes.EXIT_USAGE
    assert "nan_grad@stp=3" in capsys.readouterr().err


def test_fault_plan_fires_once_across_processes(tmp_path):
    state = str(tmp_path / "fault_plan_state.jsonl")
    reg = MetricsRegistry()
    plan = FaultPlan.parse("nan_grad@step=5*2,wedge@step=1")
    plan.bind_metrics(reg).bind_state(state)
    assert plan.pending("nan_grad") == 2
    assert not plan.fire("nan_grad", 4)
    assert plan.fire("nan_grad", 5) and not plan.fire("nan_grad", 5)
    assert plan.fire("wedge", 1)
    assert reg.counter("fault_firings") == 2
    assert reg.counter("fault_wedge") == 1 and reg.counter("fault_nan_grad") == 1
    again = FaultPlan.parse("nan_grad@step=5*2,wedge@step=1").bind_state(state)
    assert not again.fire("wedge", 1) and not again.fire("nan_grad", 5)
    assert again.fire("nan_grad", 6) and again.pending("nan_grad") == 0
    # The reference reads the port's state file the same way.
    ref = RefFaultPlan.parse("nan_grad@step=5*2,wedge@step=1")
    ref.bind_state(state)
    assert not ref.fire("wedge", 1) and not ref.fire("nan_grad", 6)


# -- manifests ---------------------------------------------------------------

PACKAGES = {"port": integrity, "reference": ref_integrity}


def _step_dir(root, name="7"):
    d = root / name
    (d / "sub").mkdir(parents=True)
    (d / "state.pt").write_bytes(bytes(range(256)) * 40)
    (d / "sub" / "extra.bin").write_bytes(b"x" * 333)
    return d


def _truncate(d):
    with open(d / "state.pt", "r+b") as f:
        f.truncate(5000)


def _bitflip(d):
    data = bytearray((d / "state.pt").read_bytes())
    data[1234] ^= 0x10
    (d / "state.pt").write_bytes(bytes(data))


def _missing(d):
    os.unlink(d / "sub" / "extra.bin")


@pytest.mark.parametrize("writer", sorted(PACKAGES))
@pytest.mark.parametrize("damage,stat_catches", [
    (None, None), (_truncate, True), (_bitflip, False), (_missing, True)],
    ids=["intact", "truncation", "bitflip", "missing"])
def test_manifests_verify_across_packages(tmp_path, writer, damage,
                                          stat_catches):
    d = _step_dir(tmp_path)
    PACKAGES[writer].write_manifest(str(d))
    assert (json.loads((d / "manifest.json").read_text())["files"].keys()
            == {"state.pt", os.path.join("sub", "extra.bin")})
    if damage is not None:
        damage(d)
    for pkg in PACKAGES.values():
        full = pkg.verify_step_dir(str(d))
        stat = pkg.verify_step_dir(str(d), level="stat")
        assert full[0] == ("verified" if damage is None else "corrupt")
        assert stat[0] == ("corrupt" if stat_catches else "verified")
        assert full == PACKAGES["reference"].verify_step_dir(str(d))


def test_manifest_bytes_equal_reference(tmp_path):
    """The same step directory gets the same manifest file from both."""
    a, b = _step_dir(tmp_path, "1"), _step_dir(tmp_path, "2")
    integrity.write_manifest(str(a))
    ref_integrity.write_manifest(str(b))
    assert (a / "manifest.json").read_bytes() == \
        (b / "manifest.json").read_bytes()


def test_torn_manifest_write_and_legacy_step(tmp_path):
    d = _step_dir(tmp_path)
    for pkg in PACKAGES.values():
        assert pkg.verify_step_dir(str(d))[0] == "unverified"
    (d / ".manifest.writing").write_text("")
    for pkg in PACKAGES.values():
        assert pkg.verify_step_dir(str(d))[0] == "corrupt"


# -- the loader's skip_batches ----------------------------------------------

SPEC = dict(num_videos=11, captions_per_video=5, max_len=9,
            feat_dims=(6, 4), feat_times=(2, 1), seed=3, rich_vocab=0)
BPE = 11 // 3


@pytest.fixture(scope="module")
def loaders(tmp_path_factory):
    root = tmp_path_factory.mktemp("skip")
    paths = jsynthetic.generate(str(root), "train",
                                jsynthetic.SyntheticSpec(**SPEC))
    ds = CaptionDataset(jsynthetic.split_paths(paths))
    split = synthetic.generate("train", synthetic.SyntheticSpec(**SPEC))
    yield (lambda: CaptionLoader(split, 3, seq_per_img=4, seed=9),
           lambda: JaxLoader(ds, batch_size=3, seq_per_img=4, seed=9))
    ds.close()


@pytest.mark.parametrize("n", [0, 1, BPE - 1, BPE, 2 * BPE + 1])
def test_skip_batches_equals_reference_loader(loaders, n):
    mine_fn, theirs_fn = loaders
    stream = mine_fn()
    served = [stream.next_batch() for _ in range(n + 4)][n:]
    mine, theirs = mine_fn(), theirs_fn()
    mine.skip_batches(n)
    theirs.skip_batches(n)
    for want in served:
        a, b = mine.next_batch(), theirs.next_batch()
        for got in (a, b):
            np.testing.assert_array_equal(got.video_ix, want.video_ix)
            np.testing.assert_array_equal(got.labels, want.labels)
            np.testing.assert_array_equal(got.weights, want.weights)
        for fa, fb in zip(a.feats, b.feats):
            np.testing.assert_array_equal(fa, fb)
    assert mine.epoch == theirs.epoch


# -- the negative-advantage detector ----------------------------------------

ADV_SEQUENCES = {
    "negative window": [-0.2, -0.1, -0.3, -0.08, -0.2, -0.4, -0.5],
    "one positive in the window": [-0.2, 0.01, -0.3, -0.2, -0.2, -0.3,
                                   -0.1, -0.2, -0.4, -0.1],
    "mean above -0.05": [-0.01, -0.02, -0.03, -0.01, -0.04, -0.02],
    "short": [-1.0, -1.0, -1.0, -1.0],
    "late collapse": [0.3, 0.2, -0.1, -0.2, -0.2, -0.3, -0.6, -0.7],
}
#: Where the detector fires on each sequence (None: never).
ADV_FIRES = {"negative window": 4, "one positive in the window": 6,
             "mean above -0.05": None, "short": None, "late collapse": 6}


def _drive(check, ns, seq):
    """-> (index at which the detector warned or raised, raised?)."""
    for i, a in enumerate(seq):
        m = {"advantage": a, "reward": 0.4 + a, "baseline": 0.4,
             "loss": 1.0}
        try:
            check(ns, m)
        except (NegativeAdvantageAbort, RefNegativeAdvantageAbort) as e:
            return i, type(e).__name__
        if getattr(ns, "_adv_warned", False):
            return i, None
    return None, None


@pytest.mark.parametrize("abort", [0, 1])
@pytest.mark.parametrize("name", sorted(ADV_SEQUENCES))
def test_negative_advantage_detector_equals_reference(name, abort):
    seq = ADV_SEQUENCES[name]
    opt = SimpleNamespace(abort_on_negative_advantage_window=abort)
    ref_ns = SimpleNamespace(opt=opt, _telemetry=MetricsRegistry(),
                             _ADV_WARN_STEPS=RefTrainer._ADV_WARN_STEPS)
    ns = SimpleNamespace(opt=opt, registry=MetricsRegistry(),
                         _ADV_WARN_STEPS=Trainer._ADV_WARN_STEPS)
    when_ref, raised_ref = _drive(RefTrainer._check_advantage_regime,
                                  ref_ns, seq)
    when, raised = _drive(Trainer._check_advantage_regime, ns, seq)
    assert when == when_ref == ADV_FIRES[name]
    assert (raised is None) == (raised_ref is None)
    if abort and when is not None:
        assert raised == NegativeAdvantageAbort.__name__
        assert ns.registry.counter("negative_advantage_aborts") == 1


# -- checkpoint trimming against the reference's orbax manager ---------------

@flax.struct.dataclass
class _RefState:
    params: dict


TRIM_SEQUENCES = {
    # (step, score or None for a recovery save)
    "rising then falling": [(1, None), (2, None), (3, 0.5), (4, None),
                            (5, None), (6, 0.5), (7, None), (8, None),
                            (9, 0.7), (10, None), (11, None), (12, 0.2)],
    "plateau": [(2, 0.3), (4, 0.3), (5, None), (6, 0.3), (8, 0.1)],
}


def _listing(d):
    main = sorted(int(n) for n in os.listdir(d) if n.isdigit())
    rec = (sorted(int(n) for n in os.listdir(d / "recovery") if n.isdigit())
           if (d / "recovery").is_dir() else [])
    return main, rec


@pytest.mark.parametrize("name", sorted(TRIM_SEQUENCES))
def test_trimming_equals_reference_manager(tmp_path, name):
    ref = RefCheckpointManager(str(tmp_path / "ref"), max_to_keep=2)
    mine = checkpoint.CheckpointManager(str(tmp_path / "port"),
                                        max_to_keep=2)
    state = _RefState(params={"w": jnp.zeros(3)})
    for step, score in TRIM_SEQUENCES[name]:
        payload = {"model": {"w": torch.full((3,), float(step))},
                   "step": step}
        if score is None:
            ref.save_recovery(step, state)
            mine.save_recovery(step, payload)
        else:
            ref.save(step, state, score=score)
            mine.save(step, payload, score=score)
    ref.close()
    assert _listing(tmp_path / "port") == _listing(tmp_path / "ref")
    assert mine.infos["best_step"] == ref.infos["best_step"]
    assert mine.infos["best_score"] == ref.infos["best_score"]
    # A best step lost to a tie restores the best retained one.
    best = checkpoint.load(str(tmp_path / "port"))
    main, _ = _listing(tmp_path / "port")
    scores = {s: v for s, v in TRIM_SEQUENCES[name] if s in main}
    assert best["step"] == min(scores, key=lambda s: (-scores[s], s))


# -- the trainer, in-process, on the CPU --------------------------------------

TINY = ["--device", "cpu", "--synthetic_videos", "12",
        "--synthetic_val_videos", "5", "--captions_per_video", "5",
        "--feat_shapes", "3x8,1x5", "--rnn_size", "16",
        "--input_encoding_size", "16", "--att_size", "16",
        "--batch_size", "4", "--seq_per_img", "5", "--max_length", "8",
        "--decode_chunk", "3", "--log_every", "1"]


def _train(argv, preemption=None):
    trainer = Trainer(train.parse_args(TINY + argv), preemption=preemption)
    try:
        return trainer.train(), trainer
    finally:
        trainer.close()


def _records(path, scope="train"):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["scope"] == scope]


def test_torn_checkpoint_walks_back_and_is_quarantined(tmp_path, caplog):
    """Run 1 tears its epoch-boundary step 3 after sealing it; run 2
    quarantines it, scrubs the best bookkeeping, resumes from the
    recovery step 2 and ends bit-identical to an untorn run."""
    ck = str(tmp_path / "torn")
    _train(["--checkpoint_path", ck, "--max_epochs", "1",
            "--save_every_steps", "1", "--fault_plan", "ckpt_torn@step=3"])
    assert integrity.verify_step_dir(os.path.join(ck, "3"))[0] == "corrupt"
    assert integrity.verify_step_dir(
        os.path.join(ck, "recovery", "2"))[0] == "verified"
    caplog.set_level("INFO")
    result, trainer = _train(["--checkpoint_path", ck, "--max_epochs", "2"])
    log = caplog.text
    assert "quarantined torn checkpoint step 3" in log
    assert "resumed from step 2" in log
    assert os.path.isdir(os.path.join(ck, "3.corrupt-quarantine"))
    assert integrity.verify_step_dir(os.path.join(ck, "3"))[0] == "verified"
    tel = json.load(open(os.path.join(ck, "telemetry.json")))
    assert tel["counters"]["checkpoints_quarantined"] == 1
    assert result["last_step"] == 6
    twin, _ = _train(["--checkpoint_path", str(tmp_path / "twin"),
                      "--max_epochs", "2"])
    a = checkpoint.load(ck, best=False)
    b = checkpoint.load(str(tmp_path / "twin"), best=False)
    assert a["step"] == b["step"] == 6
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    assert result["best_score"] == twin["best_score"]


def test_every_step_torn_starts_fresh(tmp_path, caplog):
    ck = str(tmp_path / "all")
    _train(["--checkpoint_path", ck, "--max_epochs", "1",
            "--save_every_steps", "1"])
    for base in (ck, os.path.join(ck, "recovery")):
        for name in os.listdir(base):
            if name.isdigit():
                checkpoint.CheckpointManager._tear_step(
                    os.path.join(base, name))
    caplog.set_level("INFO")
    result, _ = _train(["--checkpoint_path", ck, "--max_epochs", "1"])
    assert "resumed from" not in caplog.text
    assert caplog.text.count("quarantined torn checkpoint") == 2
    assert [r["step"] for r in _records(ck)] == [1, 2, 3, 1, 2, 3]
    assert result["last_step"] == 3


def test_walk_back_past_a_bit_flip_the_stat_scan_misses(tmp_path, caplog):
    """A flipped bit passes the start-up stat scan; the full verification
    of the resume passes it by."""
    ck = str(tmp_path / "flip")
    _train(["--checkpoint_path", ck, "--max_epochs", "1",
            "--save_every_steps", "1"])
    _bitflip(tmp_path / "flip" / "3")
    caplog.set_level("INFO")
    trainer = Trainer(train.parse_args(TINY + ["--checkpoint_path", ck,
                                               "--max_epochs", "2"]))
    assert trainer.step == 2
    assert ("newest checkpoint (step 3) failed integrity verification; "
            "resuming from the last verified step 2") in caplog.text
    trainer.close()


def test_stopped_stage_does_nothing_when_run_again(tmp_path):
    ck = str(tmp_path / "stop")
    argv = ["--checkpoint_path", ck, "--max_epochs", "9",
            "--max_patience", "1", "--learning_rate", "0"]
    first, _ = _train(argv)
    assert first["last_step"] == 6          # epoch 2 did not improve
    before = {n: os.stat(os.path.join(ck, n)).st_mtime_ns
              for n in os.listdir(ck)}
    n_records = len(_records(ck)) + len(_records(ck, "val"))
    again, _ = _train(argv)
    assert again["best_score"] == first["best_score"]
    assert again["best_step"] == first["best_step"]
    assert len(_records(ck)) + len(_records(ck, "val")) == n_records
    assert {n: os.stat(os.path.join(ck, n)).st_mtime_ns
            for n in before if n != "telemetry.json"} == \
        {n: t for n, t in before.items() if n != "telemetry.json"}


def test_save_every_steps_and_max_checkpoints_trim_as_reference(tmp_path):
    """A 3-epoch run with a recovery save every step and two scored steps
    kept: the directory holds what the reference's manager keeps for the
    same steps and scores."""
    ck = tmp_path / "trim"
    _train(["--checkpoint_path", str(ck), "--max_epochs", "3",
            "--save_every_steps", "1", "--max_checkpoints", "2",
            "--learning_rate", "1e-2"])
    val = {r["step"]: r["CIDEr"] for r in _records(str(ck), "val")}
    ref = RefCheckpointManager(str(tmp_path / "ref"), max_to_keep=2)
    state = _RefState(params={"w": jnp.zeros(1)})
    for step in range(1, 10):
        if step in val:
            ref.save(step, state, score=val[step])
        else:
            ref.save_recovery(step, state)
    ref.close()
    assert _listing(ck) == _listing(tmp_path / "ref")
    assert _listing(ck)[1] == [8]
    tel = json.load(open(ck / "telemetry.json"))
    assert tel["counters"]["checkpoints_saved"] == 9
    assert tel["histograms"]["ckpt_save_ms"]["count"] == 9


def test_save_interval_secs(tmp_path):
    """A tiny interval saves at every step between epoch boundaries; a
    long one never does."""
    ck = tmp_path / "interval"
    _train(["--checkpoint_path", str(ck), "--max_epochs", "1",
            "--save_interval_secs", "0.000001"])
    assert _listing(ck) == ([3], [2])
    assert json.load(open(ck / "telemetry.json"))["counters"][
        "checkpoints_saved"] == 3
    off = tmp_path / "off"
    _train(["--checkpoint_path", str(off), "--max_epochs", "1",
            "--save_interval_secs", "3600"])
    assert _listing(off) == ([3], [])


def test_start_from_reads_the_best_verified_step(tmp_path, caplog):
    """``--start_from`` warm-starts from the best step; when that step is
    torn, from the best retained verified one, without touching the
    directory it reads."""
    xe = str(tmp_path / "xe")
    _train(["--checkpoint_path", xe, "--max_epochs", "2",
            "--learning_rate", "1e-2"])
    infos = json.load(open(os.path.join(xe, "infos.json")))
    best = infos["best_step"]
    want = checkpoint.load(xe)
    assert want["step"] == best
    warm = Trainer(train.parse_args(TINY + [
        "--start_from", xe, "--checkpoint_path", str(tmp_path / "w")]))
    for name, p in warm.model.state_dict().items():
        assert torch.equal(p, want["model"][name]), name
    warm.close()
    _bitflip(tmp_path / "xe" / str(best))
    other = [int(s) for s in infos["step_scores"] if int(s) != best]
    caplog.set_level("INFO")
    got = checkpoint.load(xe)
    assert got["step"] == other[0] and "walking back" in caplog.text
    assert sorted(os.listdir(xe)) == sorted(
        ["3", "6", "infos.json", "metrics.jsonl", "telemetry.json"])


def test_metrics_records_carry_reference_keys(tmp_path):
    """Train and val records carry the keys of the reference chain's
    ``artifacts/cpu512_healthy/*/metrics.jsonl`` (plus the reference
    sink's ``schema``)."""
    art = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "artifacts", "cpu512_healthy")

    def keys(path, scope):
        with open(path) as f:
            return next(set(r) for r in map(json.loads, f)
                        if r["scope"] == scope)

    for stage, extra in (("xe", []), ("cst_scb_sample",
                                      ["--use_rl", "1", "--rl_baseline",
                                       "scb-sample"])):
        ck = str(tmp_path / stage)
        _train(["--checkpoint_path", ck, "--max_epochs", "1", *extra])
        ref = os.path.join(art, stage, "metrics.jsonl")
        mine = os.path.join(ck, "metrics.jsonl")
        assert keys(mine, "train") == keys(ref, "train") | {"schema"}
        assert keys(mine, "val") >= keys(ref, "val") | {"schema"}
        assert [r["step"] for r in _records(ck)] == [1, 2, 3]


def test_a_dropped_trainer_is_freed_at_once(tmp_path):
    """The watchdog's callables keep no reference to the trainer: a
    dropped trainer is freed by its reference count, without waiting for
    the cycle collector (on the card, its device memory with it)."""
    import gc
    import weakref

    for extra in ([], ["--use_rl", "1", "--wedge_timeout", "30"]):
        trainer = Trainer(train.parse_args(TINY + extra + [
            "--checkpoint_path", str(tmp_path / "t")]))
        ref = weakref.ref(trainer)
        trainer.close()
        gc.disable()
        try:
            del trainer
            assert ref() is None, extra
        finally:
            gc.enable()


def test_nan_grad_fault_is_skipped_by_the_guard(tmp_path):
    ck = str(tmp_path / "nan")
    result, trainer = _train(["--checkpoint_path", ck, "--max_epochs", "1",
                              "--fault_plan", "nan_grad@step=1"])
    losses = [r["loss"] for r in _records(ck)]
    assert np.isnan(losses[1]) and np.isfinite(losses[0])
    assert trainer.guard.total_skipped == 1 and result["last_step"] == 3


# -- preemption handler, watchdog, registry ---------------------------------

def test_preemption_handler_flags_and_counts():
    h = PreemptionHandler()
    h._handle(signal.SIGTERM, None)
    h._handle(signal.SIGTERM, None)
    assert h.requested and h.signal_name == "SIGTERM"
    assert h.drain_signal_count() == 2 and h.drain_signal_count() == 0
    e = PreemptedExit(4, "SIGTERM", False)
    assert e.step == 4 and "checkpoint already current" in str(e)


def test_preemption_handler_installs_and_uninstalls():
    before = signal.getsignal(signal.SIGTERM)
    h = PreemptionHandler().install()
    try:
        assert signal.getsignal(signal.SIGTERM) == h._handle
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):
            if h.requested:
                break
            time.sleep(0.01)
        assert h.requested
    finally:
        h.uninstall()
    assert signal.getsignal(signal.SIGTERM) == before


def test_preemption_at_a_step_boundary_in_process(tmp_path):
    """A flag set before step 2 is honored at that boundary: a verified
    recovery save, the counters, ``PreemptedExit``; the flag set again
    right after the epoch-boundary save finds the checkpoint current."""
    h = PreemptionHandler()
    trainer = Trainer(train.parse_args(TINY + [
        "--checkpoint_path", str(tmp_path / "p"), "--max_epochs", "2"]),
        preemption=h)
    orig = trainer.iteration

    def iteration():
        done = orig()
        if trainer.step == 2:
            h._handle(signal.SIGTERM, None)
        return done

    trainer.iteration = iteration
    with pytest.raises(PreemptedExit) as e:
        trainer.train()
    trainer.close()
    assert e.value.step == 2 and e.value.saved
    assert integrity.verify_step_dir(
        str(tmp_path / "p" / "recovery" / "2"))[0] == "verified"
    tel = json.load(open(tmp_path / "p" / "telemetry.json"))
    assert tel["counters"]["preempt_saves"] == 1
    assert tel["counters"]["preempt_signals"] == 1
    assert tel["gauges"]["preempt_exit_ms"] >= 0.0

    h2 = PreemptionHandler()
    resumed = Trainer(train.parse_args(TINY + [
        "--checkpoint_path", str(tmp_path / "p"), "--max_epochs", "2"]),
        preemption=h2)
    assert resumed.step == 2
    orig2 = resumed.iteration

    def iteration2():
        done = orig2()
        if resumed.step == 3:
            h2._handle(signal.SIGTERM, None)
        return done

    resumed.iteration = iteration2
    with pytest.raises(PreemptedExit) as e:
        resumed.train()
    resumed.close()
    assert e.value.step == 3 and not e.value.saved


def test_watchdog_fires_on_a_missing_beat_and_writes_heartbeats(tmp_path):
    fired = threading.Event()
    gaps = []
    hb = tmp_path / "hb" / "heartbeat.json"
    dog = ProgressWatchdog(0.3, on_timeout=lambda g: (gaps.append(g),
                                                      fired.set()),
                           heartbeat_path=str(hb),
                           payload=lambda: {"loop_step": 7})
    dog._poll_s = lambda: 0.05
    with dog:
        assert fired.wait(5.0)
    assert gaps[0] > 0.3
    doc = json.loads(hb.read_text())
    assert doc["loop_step"] == 7 and doc["timeout_s"] == 0.3
    off = ProgressWatchdog(0.0).start()
    assert off._thread is None
    off.stop()


def test_registry_snapshot_and_jsonl_sink(tmp_path):
    reg = MetricsRegistry()
    reg.declare("a", "b")
    reg.inc("a", 2)
    reg.declare("a")
    reg.set_gauge("g", 1.5)
    for v in (1.0, 3.0):
        reg.observe("h", v)
    reg.add_sink(JsonlSink(str(tmp_path / "m" / "metrics.jsonl")))
    reg.log_step(3, "train", {"loss": 1.25})
    reg.log_step(3, "val", {"CIDEr": 0.5})
    reg.flush(fsync=True)
    reg.write_snapshot(str(tmp_path / "telemetry.json"))
    reg.close()
    snap = json.load(open(tmp_path / "telemetry.json"))
    assert snap["counters"] == {"a": 2, "b": 0} and snap["schema"] == 2
    assert snap["histograms"]["h"] == {"count": 2, "sum": 4.0, "min": 1.0,
                                       "max": 3.0, "mean": 2.0}
    assert snap["last_train"] == {"step": 3, "scope": "train", "loss": 1.25}
    recs = [json.loads(x) for x in open(tmp_path / "m" / "metrics.jsonl")]
    assert [(r["schema"], r["step"], r["scope"]) for r in recs] == [
        (2, 3, "train"), (2, 3, "val")]
    assert reg.heartbeat_payload()["last_val_step"] == 3


# -- the stage harness --------------------------------------------------------

@pytest.mark.parametrize("rcs,progress,calls,final", [
    ([75, 124, 0], [True, True], 3, 0),      # resumable, wedge, done
    ([75] * 9, [False] * 9, 4, 75),           # no progress: gives up
    ([1, 0], [], 1, 1),                       # a failure is not retried
    ([124, 75, 0], [False, True], 3, 0),      # progress resets the count
], ids=["resumes", "no-progress", "failure", "progress-resets"])
def test_stage_chain_reruns_resumable_and_wedged_stages(
        tmp_path, monkeypatch, rcs, progress, calls, final):
    """``stage_chain.run_stage`` runs a stage again after exit 75 or 124,
    gives up after ``MAX_STAGE_ATTEMPTS`` attempts that moved none of the
    stage's checkpoints, and returns any other exit at once."""
    from cst_captioning_tpu_torch.tools import stage_chain

    stage = tmp_path / "stage"
    stage.mkdir()
    seen = []

    def fake_run(cmd, **kwargs):
        i = len(seen)
        seen.append(cmd)
        if i < len(progress) and progress[i]:
            (stage / str(i + 1)).mkdir()
        return SimpleNamespace(returncode=rcs[i], stdout="")

    monkeypatch.setattr(stage_chain.subprocess, "run", fake_run)
    proc = stage_chain.run_stage("xe", ["train"], str(stage),
                                 str(tmp_path / "xe.log"),
                                 stage_chain.MAX_STAGE_ATTEMPTS)
    assert proc.returncode == final and len(seen) == calls
