from .timestep_sampler import DiscreteSampling
from .train_step import (ClipAdamW, LoRATrainState, TrainState, adamw,
                         flow_matching_loss, make_lora_train_step,
                         make_train_step)
from .trainer import CoFTrainer, TrainerConfig

__all__ = ["ClipAdamW", "CoFTrainer", "DiscreteSampling", "LoRATrainState",
           "TrainState", "TrainerConfig", "adamw", "flow_matching_loss",
           "make_lora_train_step", "make_train_step"]
