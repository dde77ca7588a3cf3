from .ppo import PPOConfig, TrainState, ppo_init, ppo_train_step  # noqa: F401
