"""The sharded wave engines: one controller over a list of devices.

The port of the JAX package's ``parallel`` package. The JAX engines are
single-controller SPMD programs: one Python process drives the whole
mesh through ``shard_map``, and each wave's candidates reach the shard
that owns them through one ``lax.all_to_all``. The port keeps the one
controller and replaces the mesh by a list of devices:

* a sharded checker holds S per-shard states, shard ``s`` on
  ``devices[s]``; a device may repeat (``["cpu"] * 8`` in the CPU tests,
  ``["cuda:0"] * 4`` on one card, ``cuda:0`` … ``cuda:3`` on a host with
  four cards);
* the exchange (:mod:`.exchange`) is a stable partition of each source
  shard's candidates by owner plus one copy per (source, destination)
  pair, on the card or card to card, sized by an S×S counts matrix read
  at the wave's host sync;
* termination, counters and discoveries are host sums and minima of the
  per-shard values read at that sync.

:mod:`.engine_sortmerge` is the sort-merge family
(``CheckerBuilder.spawn_sharded_sortmerge``), :mod:`.engine` the hash
family (``spawn_sharded_hash``).
"""
