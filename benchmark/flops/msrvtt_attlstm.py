"""Model FLOPs of one training step of the attention-LSTM captioner: a
copy of the port's ``telemetry/flops.caption_step_flops``.

The matmul work of the architecture (encoder projections, the memory
projection, per-step attention, LSTM gates, vocab head) at 2 FLOPs per
multiply-add, the backward at twice the forward: the usual "model
FLOPs", so remat's recomputed cells, the reward's integer hashing and
the elementwise work are left out.  Embedding = attention = hidden
width.  CST counts the fused step: the sampled rollout and the greedy
baseline rollout (forward only, one shared encode) and the REINFORCE
gradient step (forward and backward) over the sampled captions.
"""


def caption_step_flops(batch_size, seq_per_img, seq_len, vocab, hidden,
                       feat_shapes):
    B, S, L = batch_size, seq_per_img, seq_len
    N = B * S
    H = A = hidden
    V = vocab
    feat = list(feat_shapes)
    T = sum(t for t, _ in feat)
    enc = B * sum(t * d * H for t, d in feat)   # per-modality Dense
    enc += B * (len(feat) * H) * H              # fuse Dense
    enc += B * T * H * A                        # memory_proj (attention)
    enc += B * H * 2 * H                        # state_init
    per_step = H * A + T * A + T * H + 3 * H * 4 * H + H * V
    dec = N * L * per_step
    fwd = enc + dec
    xe = 3 * fwd * 2.0                          # fwd + 2x bwd, 2 FLOPs/MAC
    greedy_dec = B * L * per_step
    cst = (enc + dec + greedy_dec) * 2.0 + xe
    return {"xe": xe, "cst": cst}


def step_flops(config: dict, traffic: dict) -> float:
    opts = traffic["options"]
    flops = caption_step_flops(
        int(opts["batch_size"]), int(config["captions_per_video"]),
        int(config["max_length"]), int(config["vocab_size"]) + 1,
        int(config["options"]["rnn_size"]),
        [tuple(s) for s in config["feat_shapes"]])
    return flops["cst" if int(opts.get("use_rl", 0)) else "xe"]
