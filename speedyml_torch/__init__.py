"""speedyml_torch: the PyTorch/CUDA port of speedyml for NVIDIA GPUs.

Each module mirrors the speedyml module of the same name. The package imports
torch, never jax and nothing of speedyml: the host modules it needs (core,
transforms.tables, the numpy helpers of reservoir.generate, physics.constants,
io.boundary, coupler.climatology and coupler.daily) are its own copies. Entry points build their tensors on the card unless the caller
names another device (`device="cpu"`, as the CPU tests do). The
configuration and calendar types are re-exported here so that a user of the
port imports only from speedyml_torch.
"""

from .core.calendar import ModelDate
from .core.config import ModelConfig, ReservoirConfig

__all__ = ["ModelConfig", "ModelDate", "ReservoirConfig"]
