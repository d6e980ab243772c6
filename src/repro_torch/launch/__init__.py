"""Launching the port across processes: the mesh of one survey shard per
``torch.distributed`` rank (:mod:`repro_torch.launch.mesh`)."""
