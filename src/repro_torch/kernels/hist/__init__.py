from repro_torch.kernels.hist.ops import hist_add, hist_max

__all__ = ["hist_add", "hist_max"]
