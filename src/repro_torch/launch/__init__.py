"""Launching the port: the mesh of one survey shard per
``torch.distributed`` rank (:mod:`repro_torch.launch.mesh`) and the GNN
cells a train step is built from (:mod:`repro_torch.launch.steps`)."""
