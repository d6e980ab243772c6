"""Launching the port: the mesh of one survey shard per
``torch.distributed`` rank (:mod:`repro_torch.launch.mesh`), the cells of
every architecture (:mod:`repro_torch.launch.steps`: ``build_cell`` /
``all_cells``, the GNN and recsys cells, the LM model FLOPs and a train
cell's optimizer), the dry run of those cells on the meta device
(:mod:`repro_torch.launch.dryrun`), the LM serving entry point
(:mod:`repro_torch.launch.serve`), the LM training entry point
(:mod:`repro_torch.launch.train`) and elastic restore
(:mod:`repro_torch.launch.elastic`)."""
