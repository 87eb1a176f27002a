"""torchmdnet_tpu_torch: the PyTorch/CUDA port of torchmdnet_tpu.

The package mirrors ``torchmdnet_tpu`` module for module (``ops/cutoff.py``,
``models/et.py``, ...) so that every part has one counterpart to be held
against.  It imports torch and numpy only.  Plain tensor code is PyTorch; the
Pallas kernels of the JAX package become hand-written CUDA kernels for Hopper
(``csrc/``), built with ``nvcc`` at first use and launched through
``torch.autograd.Function`` wrappers (``ops/kernels/``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with no
device given and no GPU present they raise.
"""

__version__ = "0.1.0"

from torchmdnet_tpu_torch.calculators import External  # noqa: F401
from torchmdnet_tpu_torch.models.potential import Potential, create_model  # noqa: F401
from torchmdnet_tpu_torch.tools.from_jax import state_dict_from_jax  # noqa: F401
