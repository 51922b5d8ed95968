"""Where the port's entry points put their tensors."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """`device` as a torch.device; None means the card. A caller who wants
    the CPU (the tests do) says so. There is no look at what the machine
    has: without a card, a call without `device` fails with torch's own
    error at the first allocation."""
    return torch.device("cuda" if device is None else device)


def to_host(a) -> np.ndarray:
    """A tensor (on any device) or an array as host numpy. On a tensor of
    the card this waits for the work that produces it."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
