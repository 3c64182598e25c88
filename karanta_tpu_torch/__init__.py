"""karanta_tpu_torch: the PyTorch/CUDA port of karanta_tpu for NVIDIA Hopper.

Module paths mirror ``karanta_tpu`` so each function's JAX counterpart is
found at the same place. The package imports ``torch`` and ``numpy`` only;
the attention kernels are hand-written CUDA for ``sm_90a`` under
``kernels/csrc`` and are built on first use.

Entry points (``Engine``, ``init_params``, ``init_params_bench``, the server
and the pipeline's ``--serve-inproc``) run on ``cuda`` unless the caller
passes ``device="cpu"``.

Importing the package loads no ``torch``: ``resolve_device`` is resolved on
first use, so the pipeline's PDF render workers (``pdf/``, ``prompts/``)
start without it.
"""

VERSION = "0.1.0"

__all__ = ["VERSION", "resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from karanta_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
