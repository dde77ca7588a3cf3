"""Median, over every ``ppo.act`` span of the window's PPO iterations (one a
rollout step and one for the bootstrap value), of its host time: the
egocentric features, the actor-critic's forward, the Gumbel-max draw and
``logp`` enqueued."""

from ..program_trace import duration_ms, roots
from ..stats import median


def read(rec, name):
    times = [duration_ms(c) for _, kids in roots(rec, "ppo.step")
             for c in kids if c.name == "ppo.act"]
    return median(times) if times else None
