"""dynamo-tpu on PyTorch and CUDA: the serving path ported to an NVIDIA Hopper card.

The package keeps the module names and layouts of ``dynamo_tpu`` (the JAX
reference, which stays untouched beside it) so every counterpart is easy to
find. It imports ``torch`` and nothing of JAX or ``dynamo_tpu``: jax-free
modules it needs are carried as copies.

Ported so far: the OpenAI HTTP frontend (``frontend/``), the in-process
discovery runtime (``runtime/``: memory store, leases, watches, in-memory
transport, endpoint clients), the KV-aware router (``router/``), the model
card and request spans, the preprocessor and backend, the engine (continuous
batching with chunked prefill fused into mixed steps, prefix caching, KV
events), dense GQA and MLA models, and three hand-written attention kernels.
``python -m dynamo_tpu_torch.launch`` (``launch.run_local``) serves N workers
behind the frontend in one process. ``ROADMAP.md`` lists what is not ported.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on the
CPU every hand-written kernel's wrapper runs its plain PyTorch version. The
CUDA kernels (``csrc/``) are built with ``nvcc`` at first use into
``_build/`` beside this file.
"""
