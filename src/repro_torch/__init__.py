"""PyTorch/CUDA port of the JAX model stack (``repro``), for an NVIDIA H100.

The JAX package stays the reference: every module here is held against its
counterpart on the same inputs by the ``tests/test_torch_*.py`` files.  The
port imports ``torch`` and nothing of ``repro``; what it needs from there
(the config dataclasses) it keeps as its own copy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; a
CUDA tensor goes through the hand-written Hopper kernels under
``repro_torch.kernels``, a CPU tensor through their plain PyTorch versions.
"""

from .device import resolve_device  # noqa: F401
