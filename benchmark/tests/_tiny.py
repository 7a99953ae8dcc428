"""Shared by the benchmark's tests: the paths, and a cell cut to a size
the CPU runs in a second (the same code paths, the kernels' plain
versions)."""

import copy
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

from cstbench import spec  # noqa: E402

CELLS = ("attlstm-cst", "attlstm-xe")


def tiny_cell(name: str):
    cell = spec.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    traffic = copy.deepcopy(cell.traffic)
    opts = cfg["options"]
    for key in ("rnn_size", "input_encoding_size", "att_size"):
        if key in opts:
            opts[key] = 32
    cfg.update(feat_shapes=[[5, 24], [1, 40]], vocab_size=60,
               captions_per_video=5, max_length=8)
    traffic["videos"] = 40
    traffic["options"]["batch_size"] = 4
    cell.config, cell.traffic = cfg, traffic
    return cell
