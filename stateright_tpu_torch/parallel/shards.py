"""What the two sharded engines share: the device list, the shard
degrade, per-shard overflow messages and the discovery fold."""

from __future__ import annotations

from typing import Optional

import torch


def fold_discoveries(props, per_shard: list, found: dict) -> None:
    """Fold one wave's per-shard verdicts into ``found``: for each
    property not yet found, the lowest shard that hit it gives the
    fingerprint of its first hitting row (the JAX engines' ``pmin``).
    ``per_shard[s]`` is shard ``s``'s ``[hits..., lo..., hi...]`` host
    row (3P ints)."""
    P = len(props)
    for i, p in enumerate(props):
        if p.name in found:
            continue
        for row in per_shard:
            if row[i]:
                found[p.name] = (row[2 * P + i] << 32) | row[P + i]
                break


class ShardedEngine:
    """The device-list half of a sharded checker (mixed in before its
    single-device engine class): ``devices``, ``n_shards``, the live
    shard ids, the degrade hooks the supervisor calls
    (checkpoint.supervised_run) and overflow messages naming a shard."""

    def _set_devices(self, devs: list) -> None:
        #: one device a shard
        self.devices = list(devs)
        self.n_shards = len(devs)
        self.device = devs[0]
        self.total_capacity = self.capacity * self.n_shards
        #: live shard ids in the ORIGINAL numbering: faultinject fires a
        #: persistent shard fault only while its shard is here, and a
        #: degrade removes the dropped one (JAX ``_shard_ids``)
        self._shard_ids = tuple(range(self.n_shards))

    def _check_device(self) -> None:
        if (any(d.type == "cuda" for d in self.devices)
                and not torch.cuda.is_available()):
            raise RuntimeError(
                "no CUDA device: the sharded engines run on the GPUs unless "
                "devices=['cpu'] * n_shards is passed")

    def _fault_shards(self) -> tuple:
        return self._shard_ids

    def _can_degrade_shards(self) -> bool:
        """Whether the supervisor may drop a shard: more than one left."""
        return self.n_shards > 1

    def _degrade_shards(self, exclude_shard=None) -> None:
        """Drop one shard (the supervisor's degrade): its device leaves
        the list, and the next resume re-shards the last snapshot onto
        the survivors through the (owner, fp) route. With no attributed
        shard the last one goes (JAX ``_degrade_shards``)."""
        if not self._can_degrade_shards():
            raise RuntimeError("shard degrade needs more than one shard")
        ids = list(self._shard_ids)
        keep = [(d, i) for d, i in zip(self.devices, ids)
                if i != exclude_shard]
        if len(keep) == len(ids):
            keep = keep[:-1]
        self.devices = [d for d, _ in keep]
        self.n_shards = len(keep)
        self.device = self.devices[0]
        self._shard_ids = tuple(i for _, i in keep)
        self.total_capacity = self.capacity * self.n_shards
        self.memory_plan = None

    def _overflow_message(self, kind: str, fps: Optional[dict] = None,
                          shard: Optional[int] = None) -> str:
        msg = super()._overflow_message(kind, fps)
        if shard is None:
            return msg
        return (f"shard {shard} of {self.n_shards}: {msg} (capacities are "
                "per shard)")
