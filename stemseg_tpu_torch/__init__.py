"""PyTorch / CUDA port of stemseg_tpu for NVIDIA Hopper GPUs.

Streaming inference for DAVIS, YouTube-VIS and KITTI-MOTS (backbone, 3D
heads, clustering kernels, online chainer, writers) and the trainer
(losses, train step, optimizer, checkpoints, training CLI) run on the GPU;
the scorers (``eval``), the accuracy runbook (``tools.eval_all``) and the
``.ckpt`` converter (``models.convert_checkpoint``) run on the host. The
JAX package beside it is the reference the tests hold this package to.
"""
