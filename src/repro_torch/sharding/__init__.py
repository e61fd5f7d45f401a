"""`repro_torch.sharding`: the distributed layer, explicit SPMD over
`torch.distributed`.

  * `api`: `Parallel` (a `DeviceMesh`, the tp and data axes, the
    partial-sum combine's ``psum_strategy``, ``remat``, ``flash_decode``,
    ``batch_split``) and `make_parallel`.
  * `rules`: the reference's name-based sharding specs over the port's
    trees, and `shard_tree`, which cuts a rank's local shard.
  * `flash_decode`: one-token attention over the sequence-sharded KV cache,
    the blocks' partial softmax sums combined across ranks.
  * `collectives`: the all-reduce and all-gather those combines call,
    counted (calls, bytes, host seconds), and their autograd forms, which
    a train step's combines call.
  * `fsdp`: where a train step's leaves live: each rank's fsdp shard of
    the params and AdamW state, gathered for the forward; the gradients
    summed over the data group and cut; the norm over the mesh.

The experts' tensor-parallel combine itself is
`repro_torch.models.moe.moe_apply(..., parallel=...)`; meshes come from
`repro_torch.launch.mesh`.
"""
