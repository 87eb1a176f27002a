"""Small helpers shared by the port's entry points."""

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names one.

    With no device given and no GPU present this raises instead of carrying on
    on the CPU: a silent CPU run would look like a working (and very slow)
    GPU run.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU explicitly"
            )
        return torch.device("cuda")
    return torch.device(device)
