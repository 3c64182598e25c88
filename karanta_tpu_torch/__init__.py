"""karanta_tpu_torch: the PyTorch/CUDA port of karanta_tpu for NVIDIA Hopper.

Module paths mirror ``karanta_tpu`` so each function's JAX counterpart is
found at the same place. The package imports ``torch`` and ``numpy`` only;
the three attention kernels of the page-OCR path are hand-written CUDA for
``sm_90a`` under ``kernels/csrc`` and are built on first use.

Entry points (``Engine``, ``init_params``, ``init_params_bench``) run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

from karanta_tpu_torch.device import resolve_device

VERSION = "0.1.0"

__all__ = ["VERSION", "resolve_device"]
