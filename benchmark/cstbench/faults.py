"""Faults planted in the program underneath a run, which the comparison
must catch (the control's and the tests' runs; never a benchmark run).
Each ``plant(trainer)`` breaks the timed path and returns what mends it.

- ``state_unchanged``: the optimizer's update leaves every parameter and
  moment as it was;
- ``half_batch``: the loss is the mean over the first half of the
  batch's caption rows, the rest left out;
- ``token_altered``: the rollout's first greedy caption has its first
  token changed where the rollout produces it;
- ``sample_altered``: the same of its first sampled caption;
- ``dropout_skipped``: the decode steps' dropout keeps every element (the
  LSTM output goes to the vocabulary head undropped);
- ``reward_altered``: the device reward's first score of each call (a
  sampled and a greedy caption's) raised by 1 where it is produced.
"""

from __future__ import annotations


def state_unchanged(trainer):
    opt = trainer.optimizer
    opt.step = lambda ok=None, norm=None: norm if norm is not None \
        else opt.grad_norm()
    return lambda: vars(opt).pop("step")


def half_batch(trainer):
    from cst_captioning_tpu_torch.training import steps

    xe, rl = steps.cross_entropy_loss, steps.reward_loss

    def first_half(fn):
        def loss(a, b, c=None, total=None):
            n = a.shape[0] // 2
            return fn(a[:n], b[:n], None if c is None else c[:n], total)
        return loss

    steps.cross_entropy_loss = first_half(xe)
    steps.reward_loss = first_half(rl)

    def mend():
        steps.cross_entropy_loss, steps.reward_loss = xe, rl
    return mend


def token_altered(trainer):
    from cst_captioning_tpu_torch.training import steps

    rollout = steps.rollout
    vocab = trainer.vocab.size_with_pad

    def altered(*args, **kwargs):
        sampled, greedy, n = rollout(*args, **kwargs)
        if greedy is not None:
            greedy[0, 0] = greedy[0, 0] % (vocab - 1) + 1
        return sampled, greedy, n

    steps.rollout = altered

    def mend():
        steps.rollout = rollout
    return mend


def sample_altered(trainer):
    from cst_captioning_tpu_torch.training import steps

    rollout = steps.rollout
    vocab = trainer.vocab.size_with_pad

    def altered(*args, **kwargs):
        sampled, greedy, n = rollout(*args, **kwargs)
        sampled[0, 0] = sampled[0, 0] % (vocab - 1) + 1
        return sampled, greedy, n

    steps.rollout = altered

    def mend():
        steps.rollout = rollout
    return mend


def dropout_skipped(trainer):
    import torch
    from cst_captioning_tpu_torch.models import captioner

    keep = captioner.dropout_keep

    def everything(shape, p, generator, device, rows=True):
        return torch.ones(shape, dtype=torch.bool, device=device)

    captioner.dropout_keep = everything

    def mend():
        captioner.dropout_keep = keep
    return mend


def reward_altered(trainer):
    from cst_captioning_tpu_torch.training import steps

    score = steps.ciderd_scores

    def altered(*args, **kwargs):
        out = score(*args, **kwargs).clone()
        out[0] += 1.0
        return out

    steps.ciderd_scores = altered

    def mend():
        steps.ciderd_scores = score
    return mend


PLANTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "token_altered": token_altered, "sample_altered": sample_altered,
          "dropout_skipped": dropout_skipped,
          "reward_altered": reward_altered}
