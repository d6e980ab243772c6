from repro_torch.kernels.intersect.ops import intersect

__all__ = ["intersect"]
