"""`repro_torch.sharding`: the distributed layer's first half, explicit
SPMD over `torch.distributed`.

  * `api`: `Parallel` (a `DeviceMesh`, the tp and data axes, the
    partial-sum combine's ``psum_strategy``, ``flash_decode``) and
    `make_parallel`.
  * `rules`: the reference's name-based sharding specs over the port's
    trees, and `shard_tree`, which cuts a rank's local shard.
  * `flash_decode`: one-token attention over the sequence-sharded KV cache,
    the blocks' partial softmax sums combined across ranks.
  * `collectives`: the all-reduce and all-gather those combines call,
    counted (calls, bytes, host seconds).

The experts' tensor-parallel combine itself is
`repro_torch.models.moe.moe_apply(..., parallel=...)`; meshes come from
`repro_torch.launch.mesh`.
"""
