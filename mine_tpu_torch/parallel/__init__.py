"""Training over a (data, fsdp, plane) mesh of ranks, one device each
(counterpart of mine_tpu/parallel/): the mesh and the process group
(mesh.py), the collectives and their backward rules (comm.py), plane-sharded
compositing (plane_sharding.py) and the step's plan on a mesh
(data_parallel.py). The fsdp axis, ZeRO-1 and the partition-rule table are
not ported yet (config.unsupported_training_options)."""
