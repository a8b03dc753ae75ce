"""What the two sharded engines share: the device list, the shard
degrade, per-shard overflow messages, the discovery fold, the
per-shard trace rows and the straggler detector."""

from __future__ import annotations

from typing import Optional

import torch


def shard_row(frontier_rows: int, pairs: int, cand: int, counts: list,
              src: int, recv_rows: int, new: int, visited: int,
              cand_peak: int) -> list:
    """One shard's ``shard_wave`` row (telemetry.SHARD_LOG_FIELDS) from
    what the wave's host sync already read: ``counts`` is the source
    shard ``src``'s row of the S×S counts matrix. ``routed_rows`` is the
    row's off-diagonal sum, ``dest_fill_peak`` its maximum (the shard's
    own destination included, as JAX's). The port sizes every copy
    exactly, so no tile cap can overflow. ``dest_cap`` is the tile the
    JAX engines' near-uniform split gives a candidate buffer sized for
    ``cand_peak``, the most candidates a shard has had in one wave of the
    run so far: four times the fair share, at least 128 rows. A balanced
    wave fills about a quarter of it, and a small skewed wave late in a
    run (duplicates of a few states share an owner) stays far below."""
    S = len(counts)
    return [int(frontier_rows), int(pairs), int(cand),
            int(sum(counts) - counts[src]), int(recv_rows),
            int(max(counts) if counts else 0),
            max(128, -(-4 * int(cand_peak) // max(S, 1))), int(new),
            int(visited)]


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

    #: one wave a chunk: the sharded engines' chunk (JAX's 16 waves a
    #: sync) is a later slice
    _chunks_waves = False

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
        #: the straggler detector (telemetry.detect_stragglers): None is
        #: off; on a traced run, a shard whose wave work passes this
        #: factor of the shard median emits a ``shard_health`` event
        #: (CLI ``--straggler-factor``)
        self.straggler_factor = None
        #: consecutive straggler waves before a shard is a SUSTAINED
        #: straggler, the supervisor's evidence
        self.straggler_sustain = 3
        #: shard id -> consecutive straggler waves
        self._shard_health: dict = {}

    def _trace_devices(self) -> tuple:
        return tuple(dict.fromkeys(self.devices))

    def _lane_config(self) -> dict:
        lane = super()._lane_config()
        # routed lanes: the state, the parent's eventually-bits, the key
        # and, with paths, the parent's key (int64 each, priced as two
        # 4-byte lanes apiece by telemetry.shard_balance)
        lanes = self.encoded.width + (3 if self.track_paths else 2)
        lane.update(n_shards=self.n_shards, bucket_capacity=None,
                    dest_tile_lanes=2 * lanes,
                    devices=[str(d) for d in self.devices])
        return lane

    # -- the straggler detector (telemetry.detect_stragglers) -------------

    def _sustained_stragglers(self) -> tuple:
        """The shards (original ids) straggling for ``straggler_sustain``
        waves in a row: the evidence ``checkpoint.classify_failure``
        attributes an anonymous fault with."""
        return tuple(s for s, n in sorted(self._shard_health.items())
                     if n >= self.straggler_sustain)

    def _note_shard_health(self, srows, wave_no: int) -> None:
        """One wave's per-shard rows through the detector: each flagged
        shard emits a ``shard_health`` event and advances its count of
        straggler waves in a row; a clean wave resets it. No-op without
        ``straggler_factor`` (JAX ``_note_shard_health``)."""
        factor = self.straggler_factor
        if not factor:
            return
        from .. import telemetry

        ids = self._shard_ids
        flagged = telemetry.detect_stragglers(srows, factor)
        hit = {rec["shard"] for rec in flagged}
        for pos, sid in enumerate(ids[:len(srows)]):
            self._shard_health[sid] = (
                self._shard_health.get(sid, 0) + 1 if pos in hit else 0)
        for rec in flagged:
            sid = ids[rec["shard"]]
            telemetry.emit(
                "shard_health", kind="straggler", shard=int(sid),
                wave=int(wave_no), factor=float(factor),
                value=int(rec["value"]), median=float(rec["median"]),
                ratio=round(float(rec["ratio"]), 4),
                sustained=int(self._shard_health.get(sid, 0)))

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
