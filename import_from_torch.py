#!/usr/bin/env python
"""Convert a checkpoint of the PyTorch port (``cst_captioning_tpu_torch``)
into a stage directory of the JAX package: the inverse of
``export_for_torch.py checkpoint``.  Runs where both packages are
installed; the port never imports it.

    python import_from_torch.py --checkpoint_path runs/chain/checkpoints/wxe \\
        --out_dir ck/wxe_from_torch

``--checkpoint_path`` is a directory the port's train CLI wrote; its best
verified step is read (the port's ``training.checkpoint.load``), and its
model's weights become the reference's Flax tree through
``cst_captioning_tpu_torch.weights.to_flax`` (float32).  ``--out_dir`` gets
what the reference's ``train.py --start_from`` and ``eval.py`` restore
(``CheckpointManager(readonly=True).restore_params(..., best=True)``): the
reference's ``TrainState`` at the checkpoint's options (the model of
``build_model``, the optimizer of ``make_optimizer``, its state fresh)
holding the imported parameters, saved through the reference's
``CheckpointManager.save`` at the port's best step with the port's best
score, and ``infos.json`` carrying ``opt`` (the reference's option
defaults, overlaid by every option of the port's saved ones the reference
also has) and ``imported_from`` (the source directory, step and score).
The directory must not hold a checkpoint yet.  Run it in a process of its
own: orbax's save and later training in one process is unstable on some
hosts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)


def reference_opts(port_opt: Dict[str, object]) -> argparse.Namespace:
    """The reference's option defaults, overlaid by the port's saved
    options wherever the reference has an option of the same name."""
    from cst_captioning_tpu.opts import build_parser

    opt = build_parser().parse_args([])
    for key, value in port_opt.items():
        if hasattr(opt, key):
            setattr(opt, key, value)
    return opt


def import_checkpoint(checkpoint_path: str, out_dir: str) -> Dict[str, object]:
    """Import the best verified step of a port train-CLI directory into
    the reference stage directory ``out_dir``; -> its ``infos.json``."""
    import jax
    import jax.numpy as jnp

    from cst_captioning_tpu.training.checkpoint import CheckpointManager
    from cst_captioning_tpu.training.state import TrainState, make_optimizer
    from cst_captioning_tpu.training.trainer import build_model
    from cst_captioning_tpu_torch.training.checkpoint import (
        CheckpointManager as PortCheckpointManager)
    from cst_captioning_tpu_torch.weights import to_flax

    src = PortCheckpointManager(checkpoint_path, readonly=True)
    step = src._resolve_step(None, best=True)
    payload = src.load(step)
    infos = src.infos
    score = infos.get("step_scores", {}).get(str(step), infos["best_score"])
    opt = reference_opts(infos.get("opt") or {})
    params = jax.tree_util.tree_map(jnp.asarray, to_flax(payload["model"]))
    logit = params["tx"]["logit"] if "tx" in params else params["logit"]
    model = build_model(opt, int(logit["kernel"].shape[1]),
                        int(opt.max_length))
    tx, _ = make_optimizer(optim=opt.optim,
                           learning_rate=opt.learning_rate,
                           grad_clip=opt.grad_clip)
    state = TrainState.create(apply_fn=model.apply, params=params, tx=tx)
    state = state.replace(step=int(step))
    dst = CheckpointManager(out_dir, max_to_keep=1)
    try:
        if dst.latest_step is not None:
            raise FileExistsError(f"{out_dir} already holds checkpoint "
                                  f"step {dst.latest_step}")
        dst.save(int(step), state, score=float(score), extra={
            "opt": vars(opt),
            "imported_from": {"path": os.path.abspath(checkpoint_path),
                              "step": int(step), "score": float(score)}})
        written = dict(dst.infos)
    finally:
        dst.close()
    return written


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint_path", required=True,
                   help="a directory the port's train CLI wrote")
    p.add_argument("--out_dir", required=True,
                   help="the reference stage directory to write")
    args = p.parse_args(argv)
    infos = import_checkpoint(args.checkpoint_path, args.out_dir)
    print(json.dumps({k: infos[k] for k in ("best_step", "best_score",
                                            "imported_from")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
