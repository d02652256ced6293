"""PyTorch/CUDA port of the APC reproduction (``repro``), for NVIDIA Hopper.

Same subpackage layout and names as ``repro``. The port imports ``torch``
and never JAX or ``repro``; the framework-free control plane is kept here
as trimmed copies. Entry points run on ``cuda`` unless the caller asks for
the CPU, where every kernel wrapper takes its plain PyTorch version.
"""
