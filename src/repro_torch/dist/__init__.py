"""Several devices: data sharding, the stage pipeline, the sharding
resolver and gradient compression (the counterpart of ``repro.dist``).

  shard_batch  data-sharded stemmer launches: one ``[n_dev * block_b, 16]``
               super-tile split across a mesh axis a launch (the serving
               path of ``StemmerWorkload(data_devices=N)``)
  pipeline     the paper's pipelined processor on a mesh: one stemmer
               stage a mesh entry, microbatches handed on each tick
  sharding     logical-axis -> mesh-axis resolver for the ParamSpec system
  compression  int8 error-feedback gradient compression

Meshes come from ``launch.mesh``. One process drives every entry of a
mesh, as the reference's ``shard_map`` has one controller.
"""
from repro_torch.dist.shard_batch import device_downshift_ladder, shard_batch
from repro_torch.dist.sharding import mesh_axis_size

__all__ = ["device_downshift_ladder", "mesh_axis_size", "shard_batch"]
