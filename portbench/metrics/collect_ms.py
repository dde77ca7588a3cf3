"""Median, over the window's PPO iterations (the program's ``ppo.step``
spans), of the iteration's ``ppo.collect`` span: the host time of the
rollout (features, forward, draw, env step, rewards and trajectory writes
of every rollout step, and the bootstrap value), which on the card waits
for the device wherever the env step's wrapper does."""

from ..program_trace import duration_ms, roots
from ..stats import median


def read(rec, name):
    times = [duration_ms(c) for _, kids in roots(rec, "ppo.step")
             for c in kids if c.name == "ppo.collect"]
    return median(times) if times else None
