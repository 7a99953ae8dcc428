"""Training CLI of the port (counterpart of the reference's ``train.py``):
one stage per run, as the reference runs them.

    XE:   python -m cst_captioning_tpu_torch.train --checkpoint_path ck/xe
    WXE:  ... --use_consensus_weights 1 --start_from ck/xe \\
              --checkpoint_path ck/wxe
    CST:  ... --use_rl 1 --rl_baseline greedy|scb-sample|scb-gt \\
              --start_from ck/wxe --checkpoint_path ck/cst

Flags keep the reference's names (its ``opts.py``).  The data are
synthetic splits built in memory from ``--synthetic_seed``
(``--synthetic_videos``, ``--synthetic_val_videos``,
``--synthetic_rich_vocab``, ``--captions_per_video``, ``--feat_shapes``,
``--max_length``), the generator of the reference's ``data/synthetic.py``.
Runs on the CUDA device unless ``--device cpu`` is given; without a GPU
it raises instead of running on the CPU.  Validation scores CIDEr-D,
which also picks the best checkpoint.  The last line of standard output
is a JSON summary: best score, its step, the last step, the metric and
the checkpoint directory.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from .training.state import OPTIMIZERS
from .training.trainer import Trainer


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    g = p.add_argument_group("data (synthetic, in memory)")
    g.add_argument("--synthetic_videos", type=int, default=512)
    g.add_argument("--synthetic_val_videos", type=int, default=128)
    g.add_argument("--synthetic_rich_vocab", type=int, default=0,
                   help="> 0: the rich grammar with word pools of about "
                        "this many words; 0: the 15-word grammar")
    g.add_argument("--captions_per_video", type=int, default=20)
    g.add_argument("--feat_shapes", default="28x2048,1x4096")
    g.add_argument("--synthetic_seed", type=int, default=0)
    g = p.add_argument_group("model")
    g.add_argument("--rnn_size", type=int, default=512)
    g.add_argument("--input_encoding_size", type=int, default=512)
    g.add_argument("--att_size", type=int, default=512)
    g.add_argument("--drop_prob", type=float, default=0.5)
    g.add_argument("--pallas_attention", type=int, default=0,
                   help="1 = the decoder's attention on the K1 kernel")
    g.add_argument("--decode_kernel", choices=("reference", "fused"),
                   default="reference",
                   help="decode cell of rollouts and validation: the "
                        "model's cell, or the K2 kernel")
    g = p.add_argument_group("optimisation")
    g.add_argument("--batch_size", type=int, default=64)
    g.add_argument("--seq_per_img", type=int, default=20)
    g.add_argument("--optim", choices=OPTIMIZERS, default="adam")
    g.add_argument("--learning_rate", type=float, default=2e-4)
    g.add_argument("--grad_clip", type=float, default=10.0)
    g.add_argument("--learning_rate_decay_rate", type=float, default=0.8)
    g.add_argument("--learning_rate_decay_every", type=int, default=3,
                   help="epochs between staircase decays; 0 disables")
    g.add_argument("--max_epochs", type=int, default=50)
    g.add_argument("--max_patience", type=int, default=5,
                   help="early stop after this many epochs without a "
                        "better val score; 0 = off")
    g.add_argument("--min_epochs", type=int, default=0)
    g.add_argument("--seed", type=int, default=123)
    g = p.add_argument_group("WXE and CST")
    g.add_argument("--use_consensus_weights", type=int, default=0)
    g.add_argument("--consensus_temperature", type=float, default=1.0)
    g.add_argument("--use_rl", type=int, default=0)
    g.add_argument("--rl_baseline", default="greedy",
                   choices=("greedy", "scb-sample", "scb-gt"))
    g.add_argument("--scb_captions", type=int, default=0)
    g.add_argument("--temperature", type=float, default=1.0)
    g.add_argument("--noise_dtype", choices=("float32", "bfloat16"),
                   default="float32",
                   help="dtype the rollout's Gumbel noise is drawn and "
                        "rounded in; bfloat16 is the draw the reference "
                        "makes under --use_bfloat16")
    g = p.add_argument_group("validation and run")
    g.add_argument("--max_length", type=int, default=30,
                   help="label length and decode length")
    g.add_argument("--val_beam_size", type=int, default=1)
    g.add_argument("--length_norm", type=float, default=0.0)
    g.add_argument("--decode_chunk", type=int, default=8)
    g.add_argument("--checkpoint_path", default="checkpoints/run")
    g.add_argument("--start_from", default=None,
                   help="warm-start the parameters from DIR/best.pt")
    g.add_argument("--log_every", type=int, default=20)
    g.add_argument("--device", default=None,
                   help="torch device; default cuda (raises without a GPU)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    opt = parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s: %(message)s")
    result = Trainer(opt).train()
    print(json.dumps({"best_score": result["best_score"],
                      "best_step": result["best_step"],
                      "last_step": result["last_step"],
                      "eval_metric": "CIDEr",
                      "checkpoint_path": opt.checkpoint_path}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
