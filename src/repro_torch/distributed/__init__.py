"""Distributed training of the port (the reference's ``distributed/``):

  - ``sharding``: the production sharding rules (parameters, optimizer
    state, batches, caches) as specs, and their DTensor placements on a
    ``DeviceMesh`` (``launch/mesh.py``);
  - ``compression``: int8 gradient all-reduce with error feedback;
  - ``pipeline``: GPipe-style forward pipelining over the "pod" axis;
  - ``fault_tolerance``: the decision layer for failures and stragglers.
"""
