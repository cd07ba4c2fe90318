"""The port's hand-written CUDA kernels, their wrappers and plain versions."""
