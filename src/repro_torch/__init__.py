"""PyTorch + CUDA port of the ``repro`` serving stack, for NVIDIA Hopper.

Sits beside the JAX package and never imports it (nor ``jax``).  Every
Pallas kernel on a ported path is a hand-written CUDA C++ kernel under
``csrc/``, built with ``nvcc`` at its first launch (``kernels/_build.py``)
and bound with ``ctypes``; each has a plain PyTorch twin that runs for CPU
tensors.  Entry points (``LM``, ``Engine``) run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

__all__ = ["configs", "models", "kernels", "serve", "bridge"]
