"""PyTorch/CUDA port of the Stem paged serving engine.

The JAX package ``repro`` is the reference; this package mirrors its module
layout (``configs``, ``core``, ``models``, ``runtime``, ``launch``,
``kernels``) and imports nothing of it.  The two TPU kernels of the paged
serving path (summary-resident page scoring and attention over selected
pages) are hand-written CUDA kernels for ``sm_90a`` in
``kernels/csrc/paged_attn.cu``; every other stage is plain PyTorch.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
