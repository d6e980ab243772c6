from repro_torch.kernels.fold_scatter.ops import fold_count_max, ring_set

__all__ = ["fold_count_max", "ring_set"]
