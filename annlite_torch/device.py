"""Device policy of the port: entry points run on the card unless the caller
asks for the CPU."""
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``'cuda'``.  Raises when CUDA is asked for (explicitly
    or by default) but absent: the port never carries on quietly on the CPU.
    Only an explicit ``'cpu'`` runs on the CPU (the kernels' plain versions)."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
