"""Hand-written Hopper kernels (``csrc/*.cu``) with their plain twins.

Each wrapper dispatches on its tensors' device: CPU tensors run the plain
PyTorch version, CUDA tensors launch the kernel or raise.  Libraries build
with ``nvcc`` at the first CUDA launch (``_build.py``), never at import.
"""
