"""Port's serving engine and JSONL server.

Captions served by the port's ``ServingEngine`` (fused cell, plain
version on the CPU) must equal, token for token, those of the reference
``ServingEngine`` on its Pallas decode cell, for greedy and beam-3, with
a bucket ladder smaller than the load so slots are recycled and the
state grows.  Then the scheduler's own contracts: queue shedding, drain,
and the stdin server's protocol, EOF exit 0 and SIGTERM exit 75.
"""

import io
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu.serving.engine import ServingEngine as JaxEngine
from cst_captioning_tpu_torch.data.vocab import Vocab
from cst_captioning_tpu_torch.ops.beam import beam_search
from cst_captioning_tpu_torch.ops.sampling import greedy_decode
from cst_captioning_tpu_torch.serving.buckets import (DEFAULT_BUCKETS,
                                                      parse_buckets,
                                                      pick_bucket)
from cst_captioning_tpu_torch.serving.engine import (ServingEngine,
                                                     _backtrack_best,
                                                     _trim_eos,
                                                     serve_decode_batch)
from cst_captioning_tpu_torch.serving.server import (EXIT_OK,
                                                     EXIT_PREEMPTED,
                                                     CaptionServer)
from cst_captioning_tpu_torch.weights import model_from_flax

N, H, E, A, V, MAX_LEN = 8, 16, 12, 16, 30, 8
FEAT_SHAPES = ((4, 8), (1, 5))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    feats = [(rng.normal(size=(N,) + s) * 2.0).astype(np.float32)
             for s in FEAT_SHAPES]
    jm = JaxCaptionModel(vocab_size=V, embed_size=E, hidden_size=H,
                         attn_size=A, dropout_rate=0.0,
                         decode_kernel="pallas")
    variables = jm.init(jax.random.PRNGKey(0),
                        [jnp.asarray(f) for f in feats],
                        np.zeros((N, MAX_LEN), np.int32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    _, model = _with_eos_bias(params, 0.2)
    return jm, model, feats, params


def _with_eos_bias(params, eos_bias):
    """(reference variables, port model) with ``eos_bias`` added to the
    EOS logit, so untrained captions end at mixed lengths."""
    params = {**params, "logit": {**params["logit"]}}
    params["logit"]["bias"] = params["logit"]["bias"].copy()
    params["logit"]["bias"][0] += eos_bias
    return ({"params": params},
            model_from_flax(params, device="cpu", decode_kernel="fused"))


def _requests(feats):
    return [[f[i] for f in feats] for i in range(N)]


@pytest.mark.parametrize("beam_size,eos_bias", [(1, 0.2), (3, 0.0)])
def test_engine_captions_identical_to_reference_engine(setup, beam_size,
                                                       eos_bias):
    jm, _, feats, params = setup
    variables, model = _with_eos_bias(params, eos_bias)
    ref = JaxEngine(jm, variables, list(FEAT_SHAPES), max_len=MAX_LEN,
                    beam_size=beam_size, decode_chunk=3, bucket_sizes=(1, 4),
                    queue_limit=0)
    eng = ServingEngine(model, FEAT_SHAPES, max_len=MAX_LEN,
                        beam_size=beam_size, decode_chunk=3,
                        bucket_sizes=(1, 4), queue_limit=0)
    for i, req in enumerate(_requests(feats)):
        assert ref.submit(i, req)
        assert eng.submit(i, req)
    want = {c.request_id: c.tokens for c in ref.run_until_idle()}
    got = {c.request_id: c.tokens for c in eng.run_until_idle()}
    assert sorted(got) == list(range(N))
    np.testing.assert_array_equal(np.stack([got[i] for i in range(N)]),
                                  np.stack([want[i] for i in range(N)]))
    lengths = {len(_trim_eos(t)) for t in got.values()}
    assert len(lengths) > 1, "captions should end at mixed lengths"
    stats = eng.stats()
    assert stats["completed"] == N and stats["slots"] == 4
    assert stats["kernel_launches"] == {"fused_additive_attention": 0,
                                        "fused_decode_cell": 0}


@pytest.mark.parametrize("beam_size", [1, 3])
def test_serve_decode_batch_matches_offline_decoders(setup, beam_size):
    _, model, feats, _ = setup
    tfeats = [torch.from_numpy(f) for f in feats]
    if beam_size == 1:
        offline = greedy_decode(model, tfeats, MAX_LEN)
    else:
        offline = beam_search(model, tfeats, beam_size, MAX_LEN)[0]
    got = serve_decode_batch(model, _requests(feats), MAX_LEN,
                             beam_size=beam_size, decode_chunk=2,
                             bucket_sizes=(2,))
    np.testing.assert_array_equal(np.stack(got), offline.numpy())


def test_bounded_queue_sheds_overflow(setup):
    _, model, feats, _ = setup
    eng = ServingEngine(model, FEAT_SHAPES, max_len=MAX_LEN,
                        bucket_sizes=(1,), queue_limit=2)
    reqs = _requests(feats)
    assert eng.submit(0, reqs[0]) and eng.submit(1, reqs[1])
    assert not eng.submit(2, reqs[2])
    stats = eng.stats()
    assert stats["shed"] == 1 and stats["queue_depth"] == 2
    assert len(eng.run_until_idle()) == 2 and eng.idle


def test_feature_shape_mismatch_rejected(setup):
    _, model, _, _ = setup
    eng = ServingEngine(model, FEAT_SHAPES, max_len=MAX_LEN)
    with pytest.raises(ValueError, match="geometry"):
        eng.submit(0, [np.zeros((3, 8), np.float32),
                       np.zeros((1, 5), np.float32)])


def test_drain_completes_residents_and_rejects_queued(setup):
    _, model, feats, _ = setup
    eng = ServingEngine(model, FEAT_SHAPES, max_len=MAX_LEN,
                        decode_chunk=2, bucket_sizes=(2,), queue_limit=0)
    for i, req in enumerate(_requests(feats)[:5]):
        eng.submit(i, req)
    first = eng.step()        # admits 2, runs one chunk, refills slots
    queued = eng.queue_depth
    done, rejected = eng.drain()
    finished = {c.request_id for c in first + done}
    rejected = {r.request_id for r in rejected}
    assert queued > 0 and len(rejected) == queued
    assert finished | rejected == set(range(5)) and not finished & rejected
    assert eng.idle and eng.stats()["rejected_drain"] == queued


def test_buckets_and_backtrack_helpers():
    assert DEFAULT_BUCKETS == (1, 4, 8)
    assert parse_buckets("8, 1,4") == (1, 4, 8)
    assert pick_bucket((1, 4, 8), 3) == 4 and pick_bucket((1, 4, 8), 99) == 8
    for bad in ("", "1,x", "0"):
        with pytest.raises(ValueError):
            parse_buckets(bad)
    # Two beams, three steps: beam 1's chain wins on score.
    toks = np.array([[4, 5], [6, 7], [0, 0]])
    pars = np.array([[0, 0], [1, 0], [0, 1]])
    row = _backtrack_best(toks, pars, torch.tensor([-3.0, -1.0]),
                          torch.tensor([3, 3]), 4, 0.0)
    assert row.tolist() == [4, 7, 0, 0]
    assert _trim_eos(np.array([3, 2, 0, 5])).tolist() == [3, 2]


def test_stdin_server_round_trip(setup):
    _, model, feats, _ = setup
    vocab = Vocab({i: f"w{i}" for i in range(1, V)})
    reqs = _requests(feats)
    eng = ServingEngine(model, FEAT_SHAPES, max_len=MAX_LEN,
                        decode_chunk=3, bucket_sizes=(1, 4), queue_limit=0)
    out = io.StringIO()
    lines = [json.dumps({"id": i, "video_id": f"v{i}"}) + "\n"
             for i in range(N)]
    lines += ["not json\n", json.dumps({"id": 99}) + "\n",
              json.dumps({"id": 98, "video_id": "nope"}) + "\n"]
    server = CaptionServer(
        eng, vocab,
        lambda vid: reqs[int(vid[1:])] if vid.startswith("v") else None,
        out=out)
    assert server.run_stdin(lines=lines) == EXIT_OK
    replies = [json.loads(ln) for ln in out.getvalue().splitlines()]
    captions = {r["id"]: r["caption"] for r in replies if "caption" in r}
    errors = sorted((r["id"] is None, r["error"]) for r in replies
                    if "error" in r)
    assert errors == [(False, "bad_request"), (False, "unknown_video"),
                      (True, "bad_request")]
    offline = greedy_decode(model, [torch.from_numpy(f) for f in feats],
                            MAX_LEN)
    assert captions == dict(enumerate(vocab.decode_batch(offline.numpy())))
    assert all(r["latency_ms"] >= 0 for r in replies if "caption" in r)


def _serve_cmd(*extra):
    return [sys.executable, "-m", "cst_captioning_tpu_torch.serve",
            "--serve_demo", "1", "--device", "cpu", "--rnn_size", "16",
            "--input_encoding_size", "16", "--att_size", "16",
            "--vocab_size", "20", "--feat_shapes", "4x16,1x8",
            "--beam_size", "1", "--serve_buckets", "1,4", *extra]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    return env


def test_serve_cli_eof_exits_0_with_every_caption():
    lines = "".join(json.dumps({"id": i, "video_id": f"v{i}"}) + "\n"
                    for i in range(6))
    proc = subprocess.run(_serve_cmd(), input=lines, capture_output=True,
                          text=True, timeout=120, cwd=REPO, env=_env())
    assert proc.returncode == EXIT_OK, proc.stderr
    replies = [json.loads(ln) for ln in proc.stdout.splitlines()]
    assert sorted(r["id"] for r in replies) == list(range(6))
    assert all("caption" in r for r in replies)
    stats = [json.loads(ln[len("serve: "):]) for ln in proc.stderr.splitlines()
             if ln.startswith("serve: {")]
    assert stats[-1]["completed"] == 6


def test_serve_cli_sigterm_drains_and_exits_75():
    proc = subprocess.Popen(
        _serve_cmd("--max_length", "300", "--serve_demo_eos_bias", "-50"),
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=REPO, env=_env())
    try:
        assert "serve: ready" in proc.stderr.readline()

        def send(ids):
            for i in ids:
                proc.stdin.write(json.dumps({"id": i, "video_id": f"v{i}"})
                                 + "\n")
            proc.stdin.flush()

        send(range(2))
        first = json.loads(proc.stdout.readline())
        send(range(2, 8))
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == EXIT_PREEMPTED, err
    assert "drained" in err
    assert "caption" in first
    for r in (json.loads(ln) for ln in out.splitlines()):
        assert "caption" in r or r["error"] == "rejected_draining"
