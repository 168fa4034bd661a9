"""PyTorch + CUDA port of ``gsorb_slam_tpu`` for NVIDIA Hopper (H100).

Mirrors the JAX package's sub-packages (``core``, ``splat``, ``raster``,
``ops``, ``slam``) and module names. Plain tensor code is PyTorch; each
Pallas kernel of the ported path is a hand-written CUDA kernel under
``csrc/``, built at first use by :mod:`gsorb_slam_tpu_torch._build`.
Entry points run on the device of their input tensors: CUDA tensors launch
the kernels, CPU tensors take the kernels' plain PyTorch versions.
"""
