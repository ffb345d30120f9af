"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its
700 W limit), as the program's ``train/profiling.py`` states them: f32
outside the tensor cores (TF32 is off) and HBM3 bandwidth."""

F32_FLOPS = 67.0e12
HBM_BYTES = 3.35e12


def least_s(flops: float, nbytes: float) -> float:
    """The least time of a function: its operations at the f32 peak or
    its bytes at the bandwidth, whichever is longer."""
    return max(flops / F32_FLOPS, nbytes / HBM_BYTES)
