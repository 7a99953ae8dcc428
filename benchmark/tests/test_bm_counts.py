"""The FLOP and byte counts equal hand-worked values at a small shape."""

import importlib.util
import os

from _tiny import BENCH

from cstbench import roofline


def _flops(name):
    path = os.path.join(BENCH, "flops", name + ".py")
    s = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.step_flops


CFG = {"captions_per_video": 2, "max_length": 3, "vocab_size": 9,
       "options": {"rnn_size": 4},
       "feat_shapes": [[2, 8], [1, 6]]}


def test_attlstm_flops_by_hand():
    # B=1, S=2, L=3, V=10, H=A=4, modalities (2, 8) and (1, 6), T=3.
    enc = 1 * (2 * 8 * 4 + 1 * 6 * 4) + 2 * 4 * 4 + 3 * 4 * 4 + 4 * 8
    per_step = 16 + 12 + 12 + 3 * 4 * 16 + 40          # 272
    dec = 2 * 3 * per_step
    xe = 3 * (enc + dec) * 2
    cst = (enc + dec + 1 * 3 * per_step) * 2 + xe
    step = _flops("msrvtt_attlstm")
    assert step(CFG, {"options": {"batch_size": 1}}) == xe
    assert step(CFG, {"options": {"batch_size": 1, "use_rl": 1}}) == cst


def test_kernel_work_by_hand():
    # K1 at B=2, T=3, A=4, H=5 in float32.
    n_bytes, n_ops = roofline.attention_work(2, 3, 4, 5, 4)
    assert n_bytes == 4 * (8 + 24 + 30 + 10 + 6) + 16
    assert n_ops == 2 * (48 + 15 + 30)
    # K2 at B=2, T=3, E=4, A=4, H=5 in bfloat16.
    n_bytes, n_ops = roofline.decode_cell_work(2, 3, 4, 4, 5, 2)
    assert n_bytes == 2 * (2 * 18 + 2 * 3 * 9 + 14 * 20 + 20 + 20) + 16
    assert n_ops == 2 * (48 + 15 + 30) + 2 * 2 * 14 * 20 + 100
    assert roofline.least_seconds(3.35e12, 1.0, "float32") == 1.0
    assert roofline.least_seconds(1.0, 67e12, "float32") == 1.0
    assert roofline.least_seconds(1.0, 989e12, "bfloat16") == 1.0
