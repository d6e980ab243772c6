"""Launching the port: the mesh of one survey shard per
``torch.distributed`` rank (:mod:`repro_torch.launch.mesh`), the GNN
cells a train step is built from and the LM model FLOPs
(:mod:`repro_torch.launch.steps`), and the LM serving driver
(:mod:`repro_torch.launch.serve`)."""
