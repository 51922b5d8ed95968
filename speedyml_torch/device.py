"""Where the port's entry points put their tensors."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """`device` as a torch.device; None means the card. A caller who wants
    the CPU (the tests do) says so. There is no look at what the machine
    has: without a card, a call without `device` fails with torch's own
    error at the first allocation."""
    return torch.device("cuda" if device is None else device)
