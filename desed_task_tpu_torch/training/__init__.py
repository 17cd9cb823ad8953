from .mean_teacher import (  # noqa: F401
    ClipAdam,
    MeanTeacherConfig,
    MeanTeacherState,
    SlotSpec,
    create_state,
    make_optimizer,
    make_predict_step,
    make_train_step,
    make_train_step_sharded,
)
from .schedulers import ExponentialWarmup  # noqa: F401
