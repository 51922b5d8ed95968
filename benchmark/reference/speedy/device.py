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


def script_device(cpu: bool) -> torch.device:
    """The device of a script of scripts_torch: the CPU when its --cpu flag
    asks for it, else the card. Without a card and without --cpu the script
    stops with a nonzero exit code: it never carries on on the CPU by
    itself."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script runs on the card; "
                         "pass --cpu to run it on the CPU")
    return torch.device("cuda")


def to_host(a) -> np.ndarray:
    """A tensor (on any device) or an array as host numpy. On a tensor of
    the card this waits for the work that produces it."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


class Download:
    """Tensors on their way to the host. On the card the copies go into
    pinned host buffers on `side_stream`, after the work already queued on
    the current stream, so they overlap the kernels queued next; `arrays()`
    waits on the event recorded behind them. On the CPU (side_stream None)
    the tensors are the host arrays already. The first `upto` entries of
    each are kept."""

    def __init__(self, tensors, upto: int, side_stream):
        self.upto = upto
        self._src = tensors          # held until the copies are done
        self._event = None
        if side_stream is None:
            self._host = tensors
            return
        side_stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side_stream):
            self._host = [torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True).copy_(
                                          t, non_blocking=True)
                          for t in tensors]
            self._event = torch.cuda.Event()
            self._event.record(side_stream)

    def arrays(self):
        if self._event is not None:
            self._event.synchronize()
        self._src = None
        return [h.numpy()[:self.upto] for h in self._host]
