"""The multi-rank layer of the port: the reference's ``repro/parallel``.

* ``sharding`` — the logical sharding rules (parameter, batch and cache
  specs) and their DTensor placements;
* ``ctx`` — the activation-sharding context the model's ``shard`` calls
  read;
* ``pipeline`` — the GPipe schedule over a "stage" mesh dimension.

Nothing here touches a process group or a device when it is imported."""
