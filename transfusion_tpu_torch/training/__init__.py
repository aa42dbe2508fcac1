from transfusion_tpu_torch.training.ema import EMA, EmaState, ema_update, init_ema
from transfusion_tpu_torch.training.optim import (
    MultiSteps,
    adam,
    adam_atan2,
    apply_updates,
    chain,
    clip_by_global_norm,
    global_norm,
    multi_transform,
    muon,
    muon_adam_atan2,
    muon_param_mask,
)
from transfusion_tpu_torch.training.trainer import Trainer, TrainState

__all__ = ["EMA", "EmaState", "MultiSteps", "TrainState", "Trainer", "adam", "adam_atan2",
           "apply_updates", "chain", "clip_by_global_norm", "ema_update", "global_norm",
           "init_ema", "multi_transform", "muon", "muon_adam_atan2", "muon_param_mask"]
