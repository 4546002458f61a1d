"""Hand-written CUDA kernels of the port and their plain PyTorch versions
(ops.py dispatches on the tensor's device; build.py compiles csrc/ with
nvcc at first use)."""
