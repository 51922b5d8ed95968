"""speedyml_torch: the PyTorch/CUDA port of speedyml for NVIDIA GPUs.

Each module mirrors the speedyml module of the same name. The package imports
torch, never jax and nothing of speedyml: the host modules it needs (core,
transforms.tables, the numpy helpers of reservoir.generate, physics.constants,
io.{boundary,checkpoint,ncstream,output,era},
coupler.{climatology,daily,anomaly}) are its own copies. Entry points build
their tensors on the card unless the caller names another device
(`device="cpu"`, as the CPU tests do). The configuration and calendar types
and what a user of the training pipeline (generate -> train -> ML-only
variant, or train from ERA-schema files), of the coupled closed loop and of
the ensemble needs are re-exported here, so that such a user imports only from
speedyml_torch.
"""

from .core.calendar import ModelDate
from .core.config import HybridConfig, ModelConfig, ReservoirConfig
from .hybrid.ensemble import EnsembleHybrid
from .hybrid.era_training import train_from_era
from .hybrid.experiment import ml_variant, train_hybrid
from .hybrid.fastloop import ScanHybridRunner
from .hybrid.forecast import FusedDataGenerator
from .io.era import ObservedBoundary
from .io.weights import load_model, save_model
from .reservoir.slab import OceanModel, train_ocean

__all__ = ["EnsembleHybrid", "FusedDataGenerator", "HybridConfig",
           "ModelConfig", "ModelDate",
           "ObservedBoundary", "OceanModel", "ReservoirConfig",
           "ScanHybridRunner", "load_model", "ml_variant", "save_model",
           "train_from_era", "train_hybrid", "train_ocean"]
