"""Deterministic shard assignment and the global epoch shuffle
(counterpart of the reference's ``data/sharding.py``; an own copy, numpy
only).

The sharded data plane's contract:

- **A partition, exactly.**  Every epoch, the N shards of a split are the
  N strided slices of ONE global permutation: their union is the epoch,
  no video twice and none dropped.
- **A pure-function shuffle.**  The global permutation is a function of
  ``(seed, epoch)`` alone and draws nothing from the loader's
  caption-row generator, so ``CaptionLoader.skip_batches`` replays a
  resumed sharded run draw for draw, at any shard count.
- **The shard's identity from the options.**  ``--data_shards`` and
  ``--data_shard_id`` (fallbacks ``CST_DATA_SHARDS`` and
  ``CST_DATA_SHARD_ID``) name the shard, so a run restarted elsewhere
  keeps it.  ``--data_shards 0`` (the default) keeps the unsharded
  stream.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

#: The options' environment fallbacks.
ENV_SHARDS = "CST_DATA_SHARDS"
ENV_SHARD_ID = "CST_DATA_SHARD_ID"

#: Domain separation of the epoch shuffle's generator from every other
#: consumer of ``--seed`` (the caption draws, the weights, the noise).
_SHUFFLE_SALT = 0x5AD0


@dataclass(frozen=True)
class ShardSpec:
    """One shard's identity: ``shard_id`` of ``num_shards``."""

    num_shards: int
    shard_id: int

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError(
                f"num_shards must be >= 1, got {self.num_shards}")
        if not 0 <= self.shard_id < self.num_shards:
            raise ValueError(
                f"shard_id must satisfy 0 <= shard_id < num_shards "
                f"({self.shard_id} vs {self.num_shards})")


def resolve_shard_spec(data_shards: int,
                       data_shard_id: int) -> Optional[ShardSpec]:
    """The options -> a ``ShardSpec``, or None for the unsharded stream
    (``data_shards`` 0)."""
    if not data_shards:
        return None
    return ShardSpec(int(data_shards), int(data_shard_id))


def global_epoch_order(num_videos: int, seed: int,
                       epoch: int) -> np.ndarray:
    """THE global shuffle of epoch ``epoch``, the same on every shard: a
    fresh generator per call, so epoch 7's order never needs epochs
    0..6."""
    rng = np.random.default_rng([_SHUFFLE_SALT, int(seed), int(epoch)])
    return rng.permutation(int(num_videos))


def shard_epoch_order(num_videos: int, seed: int, epoch: int,
                      spec: ShardSpec, shuffle: bool = True) -> np.ndarray:
    """This shard's slice of epoch ``epoch``: positions
    ``shard_id::num_shards`` of the global permutation (of the identity
    order without ``shuffle``)."""
    order = (global_epoch_order(num_videos, seed, epoch) if shuffle
             else np.arange(int(num_videos)))
    return order[spec.shard_id::spec.num_shards]


def shard_size(num_videos: int, spec: ShardSpec) -> int:
    """``len(shard_epoch_order(...))`` without building it."""
    n, k, s = int(num_videos), spec.shard_id, spec.num_shards
    return (n - k + s - 1) // s


def _nonneg_int(flag: str):
    def parse(text: str) -> int:
        try:
            value = int(text)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"{flag}: not an integer: {text!r}") from None
        if value < 0:
            raise argparse.ArgumentTypeError(f"{flag}: must be >= 0, got "
                                             f"{value}")
        return value
    return parse


def add_shard_args(group) -> None:
    """``--data_shards`` and ``--data_shard_id``, with their environment
    fallbacks (a malformed value is a usage error, as a malformed flag)."""
    group.add_argument(
        "--data_shards", type=_nonneg_int(f"--data_shards (or {ENV_SHARDS})"),
        default=os.environ.get(ENV_SHARDS) or 0,
        help="shard count of the training stream: this run reads its "
             "strided slice of each epoch's global shuffle; 0 (default) = "
             f"unsharded.  Fallback: {ENV_SHARDS}")
    group.add_argument(
        "--data_shard_id",
        type=_nonneg_int(f"--data_shard_id (or {ENV_SHARD_ID})"),
        default=os.environ.get(ENV_SHARD_ID) or 0,
        help="this run's shard, 0 <= id < --data_shards.  Fallback: "
             f"{ENV_SHARD_ID}")


def check_shard_args(parser: argparse.ArgumentParser,
                     ns: argparse.Namespace) -> None:
    """The relation of the two flags, as a usage error."""
    shards, shard_id = int(ns.data_shards), int(ns.data_shard_id)
    if shards == 0 and shard_id != 0:
        parser.error(f"--data_shard_id {shard_id} needs --data_shards >= 1 "
                     "(0 shards = the unsharded stream, which has no shard "
                     "ids)")
    if shards and not 0 <= shard_id < shards:
        parser.error("--data_shard_id must satisfy 0 <= id < --data_shards, "
                     f"got id {shard_id} with {shards} shard(s)")
