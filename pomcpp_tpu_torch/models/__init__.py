from .actor_critic import ActorCritic, obs_to_features  # noqa: F401
