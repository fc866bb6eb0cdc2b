"""Tensor ops and the CUDA kernel wrappers (kernels build at first use)."""
