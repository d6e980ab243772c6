"""Launching the port: the mesh of one survey shard per
``torch.distributed`` rank (:mod:`repro_torch.launch.mesh`), the GNN
cells a train step is built from, the LM model FLOPs and a train cell's
optimizer (:mod:`repro_torch.launch.steps`), the LM serving driver
(:mod:`repro_torch.launch.serve`), the LM training driver
(:mod:`repro_torch.launch.train`) and elastic restore
(:mod:`repro_torch.launch.elastic`)."""
