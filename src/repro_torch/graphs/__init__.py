from repro_torch.graphs.partition import owner_of, local_of, global_of
from repro_torch.graphs.csr import HostGraph, MetaSpec
from repro_torch.graphs import generators

__all__ = ["owner_of", "local_of", "global_of", "HostGraph", "MetaSpec",
           "generators"]
