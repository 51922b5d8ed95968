"""speedyml_torch: the PyTorch/CUDA port of speedyml for NVIDIA GPUs.

Each module mirrors the speedyml module of the same name. The package imports
torch, never jax and nothing of speedyml: the host modules it needs (core,
transforms.tables, the numpy helpers of reservoir.generate, physics.constants,
io.{boundary,checkpoint,ncstream,output}, coupler.{climatology,daily,anomaly})
are its own copies. Entry points build their tensors on the card unless the
caller names another device (`device="cpu"`, as the CPU tests do). The
configuration and calendar types and what a user of the coupled closed loop
needs are re-exported here, so that such a user imports only from
speedyml_torch.
"""

from .core.calendar import ModelDate
from .core.config import ModelConfig, ReservoirConfig
from .hybrid.fastloop import ScanHybridRunner
from .io.weights import load_model, save_model
from .reservoir.slab import OceanModel, train_ocean

__all__ = ["ModelConfig", "ModelDate", "OceanModel", "ReservoirConfig",
           "ScanHybridRunner", "load_model", "save_model", "train_ocean"]
