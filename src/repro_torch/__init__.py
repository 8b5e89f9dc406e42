"""PyTorch / CUDA port of the MapReduce-model reproduction (``repro``).

The same round machine, plans and sample sort as the JAX package, for one
NVIDIA H100: plain tensor code is PyTorch and the TPU kernels on the path
are hand-written CUDA (:mod:`repro_torch.kernels`).  It imports no JAX and
nothing of ``repro``.  Entry points run on the card unless the caller asks
for the CPU (``device="cpu"``)."""
