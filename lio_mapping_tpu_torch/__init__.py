"""lio_mapping_tpu_torch: the LIO-mapping engine in PyTorch for one NVIDIA H100.

A port of ``lio_mapping_tpu`` (the JAX/XLA/Pallas reference, which stays in
the repository unchanged). Plain tensor code is PyTorch; the reference's one
Pallas kernel (the exact KNN) is a hand-written CUDA kernel for ``sm_90a``
(``csrc/knn.cu``, bound in ``ops/knn_kernel.py``). The layout mirrors the
reference: ``utils/``, ``ops/``, ``models/``, ``io/`` and ``parallel/`` (the
distributed estimator over ``torch.distributed``, one process per rank) with
the same module and function names. Nothing here imports ``jax`` or
``lio_mapping_tpu``.

Entry points take an explicit ``device`` and ``dtype``; the pipeline runs on
the card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

import torch as _torch

# Full f32 everywhere, as the reference pins (lio_mapping_tpu/__init__.py:
# bf16-class matmuls cost ~10x ATE on this estimator). TF32 keeps ~3 digits.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
