"""Sharding the edit over ranks (counterpart of ``blobctrl_tpu/parallel/``).

The JAX package gets its sharding from GSPMD: the program is global and
``shard_map`` marks the manual regions around the Pallas kernels. PyTorch
has no GSPMD, and the port's kernels write raw pointers into plain tensors,
so the port shards by explicit SPMD on ``torch.distributed``: every rank
runs the same edit on local slices of the weights, and collectives run
where the JAX recipe's ``shard_map`` bodies reduce or where GSPMD must
gather. The hand kernels only ever see local tensors.

  * ``multihost``: process-group bring-up, rank helpers, spawned followers.
  * ``collectives``: every collective, counted (op, payload bytes, model).
  * ``mesh``: the data x model rank grid, the Megatron table, local slices.
  * ``kernel_sharding``: per-model profiles and the call-site helpers.
"""
