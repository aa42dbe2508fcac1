from transfusion_tpu_torch.training.ema import EmaState, ema_update, init_ema
from transfusion_tpu_torch.training.trainer import Trainer, TrainState

__all__ = ["EmaState", "TrainState", "Trainer", "ema_update", "init_ema"]
