from .optim import AdamWConfig, adamw_update, global_norm, init_opt_state
from .schedule import constant, warmup_cosine
from .train_step import make_eval_step, make_train_step

__all__ = ["AdamWConfig", "adamw_update", "global_norm", "init_opt_state",
           "constant", "warmup_cosine", "make_eval_step", "make_train_step"]
