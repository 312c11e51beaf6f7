from .losses import cut3r_total_loss, regr3d_pose_loss, conf_loss  # noqa: F401
from .train_step import (make_optimizer, make_train_step,  # noqa: F401
                         make_tbptt_train_step, init_train_state,
                         init_trainable)
