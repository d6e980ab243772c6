from repro_torch.kernels.wedge_intersect.ops import wedge_intersect
