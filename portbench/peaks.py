"""The card's ceilings and the operation and byte counts a bound divides.

Copied from the port's smoke script and device module at commit
d0a03242271a (``chip_smoke.py`` ``STATE_BYTES``, ``FSM_BYTES``,
``bound_ms``; ``pomcpp_tpu_torch/device.py`` ``card_rates``), so that a
change to the program cannot move the yardstick.
"""

from __future__ import annotations

import subprocess
from typing import NamedTuple

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 memory rate
ISSUE_LANES = 128            # 32-bit instructions a clock per SM (4 x 32 lanes)
CELLS = 121                  # an 11 x 11 board
STATE_BYTES = 7 * CELLS * 4 + 7 * 4 * 4   # one board's 14 state arrays, int32
FSM_BYTES = 10 * 4 * 4                    # one board's ten FSM arrays


class Rates(NamedTuple):
    sms: int
    clock_mhz: float     # the SM clock's maximum
    issue: float         # 32-bit instructions a second: 128 lanes x SMs x clock
    hbm: float = HBM_BYTES_PER_S


def card_rates(index: int = 0) -> Rates:
    """Rates of card ``index``: its SM count from the CUDA runtime, its
    maximum SM clock from ``nvidia-smi``."""
    import torch

    sms = torch.cuda.get_device_properties(index).multi_processor_count
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    return Rates(sms, mhz, ISSUE_LANES * sms * mhz * 1e6)


def card_power_limit_w(index: int = 0) -> float | None:
    """The card's power limit in watts, as ``nvidia-smi`` reads it."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True)
    try:
        return float(out.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        return None


def chunk_bytes(boards: int, policy: str) -> int:
    """The bytes a chunk moves: every board's state (and with the
    SimpleAgent its FSM state) read once and written once."""
    per_board = STATE_BYTES + (FSM_BYTES if policy == "simple" else 0)
    return boards * 2 * per_board


def bound_s(board_steps: int, bytes_moved: int, rates: Rates) -> float:
    """Least time: bytes over the memory rate vs one 32-bit instruction per
    state value per board-step (7 planes x 121 cells) over the issue rate.
    A floor, the same for every policy: it leaves out the SimpleAgent's
    work."""
    return max(bytes_moved / rates.hbm, board_steps * 7 * CELLS / rates.issue)
