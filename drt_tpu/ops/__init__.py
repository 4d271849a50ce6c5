from drt_tpu.ops import vecmath, intersect, bxdf, pathkernel

__all__ = ["vecmath", "intersect", "bxdf", "pathkernel"]
