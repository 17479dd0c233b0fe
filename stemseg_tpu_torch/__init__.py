"""PyTorch / CUDA port of stemseg_tpu for NVIDIA Hopper GPUs.

The streaming DAVIS inference path (backbone, 3D heads, clustering kernels,
online chainer, DAVIS writer) runs on the GPU; the JAX package beside it is
the reference the tests hold this package to.
"""
