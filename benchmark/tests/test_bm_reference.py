"""The plain reference agrees with the port at a tiny size on the CPU
(the kernels' plain versions): the teacher-forced logits, with and
without the program's dropout masks, CIDEr-D against the port's host and
device scorers, and whole runs of every cell, which come out correct."""

import types

import numpy as np
import pytest
import torch

from _tiny import CELLS, tiny_cell

from cstbench import check, inputs, program, session
from cstbench.reference import models
from cstbench.reference.ciderd import CiderD

CPU = torch.device("cpu")


@pytest.mark.parametrize("train", [False, True])
def test_reference_logits_equal_the_ports(train):
    from cst_captioning_tpu_torch import train as cli
    from cst_captioning_tpu_torch.training.trainer import build_model

    cell = tiny_cell("attlstm-xe")
    cfg = cell.config
    arrays = inputs.make_split(5, cell.traffic, cfg, CPU)
    argv = program.trainer_argv(cfg, cell.traffic, 5, "cpu", "unused",
                                False)
    model = build_model(cli.parse_args(argv), len(arrays.words),
                        [d for _, d in cfg["feat_shapes"]])
    weights = inputs.make_weights(5, models.layout(cfg, len(arrays.words)),
                                  CPU)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    feats = [torch.from_numpy(f[:3]) for f in arrays.feats]
    labels = torch.from_numpy(arrays.labels[:3].reshape(
        -1, cfg["max_length"])).long()
    spi = cfg["captions_per_video"]
    p = cell.traffic["options"]["drop_prob"]
    drops = None
    with torch.no_grad():
        if train:
            seen = program.Observer(types.SimpleNamespace(next_batch=None))
            seen.masks.append([])
            try:
                theirs = model(feats, labels, spi, train=True,
                               generator=torch.Generator().manual_seed(9))
            finally:
                seen.close()
            sites = check.dropout_sites(seen.masks[0],
                                        session.dropout_shapes(cfg, 3))
            assert sites is not None
            drops = models.Drops(p, sites[0], sites[1], sites[2:])
        else:
            theirs = model(feats, labels, spi)
        ours = models.logits(weights, feats, labels, spi, drops)
    assert torch.allclose(ours, theirs, rtol=1e-5, atol=1e-5)


def test_ciderd_equals_the_ports_scorers():
    from cst_captioning_tpu_torch.metrics.ciderd import (CiderD as Host,
                                                         build_corpus_df)
    from cst_captioning_tpu_torch.ops.device_ciderd import ciderd_scores
    from cst_captioning_tpu_torch.training.device_rewards import \
        build_device_tables

    labels, words = inputs.make_captions(9, 30, 5, 10, 60)
    refs = {str(v): [" ".join(words[i] for i in r if i) for r in labels[v]]
            for v in range(30)}
    ours = CiderD(labels.tolist())
    rng = np.random.default_rng(0)
    hyps = np.concatenate([labels[:10, 3], rng.integers(0, 60, (10, 10))])
    hyps[12, 4:] = 0
    vids = np.arange(20) % 30
    mine = [ours.score(h, int(v)) for h, v in zip(hyps.tolist(), vids)]
    df, n = build_corpus_df(refs)

    def text(h):
        h = h[:h.index(0)] if 0 in h else h
        return " ".join(words[i] for i in h)

    _, host = Host(df=df, ref_len=n).compute_score(
        {str(v): refs[str(v)] for v in vids},
        [{"image_id": str(v), "caption": [text(h)]}
         for h, v in zip(hyps.tolist(), vids)])
    corpus, tables, _ = build_device_tables(
        refs, {w: i for i, w in enumerate(words) if i})
    dev = ciderd_scores(torch.from_numpy(hyps).long(),
                        torch.from_numpy(vids), corpus, tables)
    assert np.allclose(mine, host, rtol=1e-9, atol=1e-12)
    assert np.allclose(mine, dev.numpy(), rtol=1e-5, atol=1e-6)
    assert max(mine[:10]) > 1.0


@pytest.mark.parametrize("name", CELLS)
def test_a_run_of_every_cell_is_correct(name):
    cell = tiny_cell(name)
    rec = session.run(cell, 3_000_000_019, 0.5, False, CPU, 0.0)
    assert rec.steps >= 1
    assert rec.numbers["batch"] == 0
    limits = cell.limits["limits"]
    assert set(rec.numbers) == set(limits)
    for key, value in rec.numbers.items():
        assert value <= (limits[key] if key.endswith("_z") else 1e-4), \
            (key, value)
    assert check.verdict(rec.numbers, cell.limits["limits"])


def test_the_draws_are_judged_by_their_law():
    g = torch.Generator().manual_seed(1)
    gumbel = [-torch.log(-torch.log(torch.rand(400, 500, generator=g)
                                    .clamp_(min=1e-38))) for _ in range(3)]
    assert check.noise_z([gumbel]) < 5
    assert check.noise_z([[x * 0.9 for x in gumbel]]) > 50
    assert check.noise_z([[x + 0.01 for x in gumbel]]) > 5
    assert check.noise_z([[]]) == check.MISSING
    masks = [torch.rand(64, 512, generator=g) < 0.5 for _ in range(4)]
    assert check.dropout_z([masks], 0.5) < 5
    assert check.dropout_z([masks + [torch.ones(64, 512, dtype=bool)]],
                           0.5) > 100
    assert check.dropout_z([masks, None], 0.5) == check.MISSING
    shapes = [(64, 512)] * 4
    assert check.dropout_sites(masks, shapes) == masks
    assert check.dropout_sites(masks[:3], shapes) is None
