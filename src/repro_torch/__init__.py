"""SpeedyFeed in PyTorch for NVIDIA Hopper (H100).

A port of the JAX package ``repro`` that imports no JAX and nothing of
``repro``. The BusLM attention and the PQ LUT scan are hand-written CUDA
kernels (``kernels/csrc``); everything else is plain PyTorch. Entry
points run on the card unless the caller passes ``device="cpu"``.
"""
