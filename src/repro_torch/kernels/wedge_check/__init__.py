from repro_torch.kernels.wedge_check.ops import wedge_check
