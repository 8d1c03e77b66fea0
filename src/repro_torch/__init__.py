"""PyTorch/CUDA port of the ``repro`` serving and training stack for
NVIDIA Hopper.

Module paths mirror ``repro`` so each piece has an obvious counterpart:
``configs`` (the same ModelConfig data), ``kernels`` (plain-torch
versions in ``kernels/ref.py`` plus hand-written CUDA kernels under
``csrc/``, dispatched by the tensor's device in ``kernels/ops.py``),
``models`` (layers, attention, the paged KV pool, the decoder-only LM
and the JAX weight bridge), ``launch`` (the paged serving Engine and
its CLI, the trainer), ``optim`` / ``data`` / ``checkpoint`` (the
training stack; checkpoints in the JAX package's format), ``tree``
(nested-dict trees in JAX's flatten order) and ``core`` (the EPAC tile
layer: precision environments, VRP expansion arithmetic, VBLAS, Krylov
solvers, the VEC and STX tiles and the tile policy).

The package imports ``torch`` and ``numpy`` only: never ``jax`` and
nothing of ``repro``. Entry points take ``device`` (default ``"cuda"``)
and raise when no GPU is present; pass ``device="cpu"`` to run the
plain-torch path.
"""
