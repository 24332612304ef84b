"""maxmq-tpu-torch: the maxmq matcher service on PyTorch and CUDA.

A port of ``maxmq_tpu``'s signature matcher (the production ``matcher =
"sig"`` path) to an NVIDIA Hopper card. The package stands alone: it
imports ``torch`` and ``numpy`` and nothing of ``maxmq_tpu`` or JAX,
keeping its own copies of the host layers it needs. Its one device
kernel, ``csrc/sig_match.cu``, is hand-written CUDA C++ built with
``nvcc`` at first use (``kernels.py``).

Entry points run on the card unless the caller passes ``device="cpu"``
(``--device cpu`` on the command line); with no CUDA device and no
explicit CPU request they raise.
"""

__version__ = "0.1.0"
