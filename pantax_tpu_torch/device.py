"""Device selection.  Nothing in the port picks a device on its own: callers
pass ``device`` explicitly, and the card's entry points call require_cuda()
so a missing GPU fails loudly instead of running on the CPU."""
from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The first CUDA device; raises when torch sees no usable GPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: this entry point runs only on a GPU"
        )
    return torch.device("cuda", 0)


def card_unless(device) -> torch.device:
    """``device`` as a torch.device, or the card (require_cuda) when it is
    None: the default of the entry points that run on the card unless the
    caller names another device."""
    return require_cuda() if device is None else torch.device(device)
