"""dynamo-tpu on PyTorch and CUDA: the serving path ported to an NVIDIA Hopper card.

The package keeps the module names and layouts of ``dynamo_tpu`` (the JAX
reference, which stays untouched beside it) so every counterpart is easy to
find. It imports ``torch`` and nothing of JAX or ``dynamo_tpu``: jax-free
modules it needs are carried as copies.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on the
CPU every hand-written kernel's wrapper runs its plain PyTorch version. The
CUDA kernels (``csrc/``) are built with ``nvcc`` at first use into
``_build/`` beside this file.
"""
