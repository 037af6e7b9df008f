"""Hand-written CUDA kernels (csrc/), their nvcc build and their plain twins."""
