from .environment import (  # noqa: F401
    EnvState,
    env_reset,
    env_reset_np,
    env_step,
    env_step_auto_reset,
    env_step_auto_reset_batch,
    env_step_auto_reset_batch_fsm,
    rollout,
    rollout_stateful,
)
from .gym_adapter import PommermanEnv  # noqa: F401
from .observation import Observation, observe, observe_ego  # noqa: F401
