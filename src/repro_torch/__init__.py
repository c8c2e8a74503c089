"""PyTorch/CUDA port of the quantized federated-learning system.

A second package beside ``repro`` (the JAX reference).  It imports
``torch`` and ``numpy`` only — never ``jax`` and nothing of ``repro`` — and
keeps the same module paths wherever ``repro`` has a counterpart.  Entry
points run on the CUDA device unless the caller passes ``device="cpu"``;
the hot transforms (quantize, dequantize, eq. 6 aggregation) are CUDA C++
kernels under ``kernels/csrc`` built at first use.
"""
