"""The copied operation and byte counts against the state's shapes."""

import pytest

from portbench import peaks
from portbench.drivers.common import Record
from portbench.metrics import chunk_roofline_pct

H100 = peaks.Rates(sms=132, clock_mhz=1980.0,
                   issue=peaks.ISSUE_LANES * 132 * 1980e6)


def test_state_bytes_are_the_kernel_side_arrays():
    from pomcpp_tpu_torch.core.board_gen import random_cell_state
    from pomcpp_tpu_torch.engine.fsm import simple_fsm_state_init

    cs = random_cell_state(2, 0, device="cpu")
    per_board = sum(t[0].numel() * 4 for t in list(cs)[:14])
    assert per_board == peaks.STATE_BYTES == 3500
    fsm = simple_fsm_state_init(2, "cpu")
    assert sum(t[0].numel() * t.element_size() for t in fsm) == peaks.FSM_BYTES
    assert peaks.chunk_bytes(16384, "simple") == 16384 * 2 * (3500 + 160)
    assert peaks.chunk_bytes(16384, "harmless") == 16384 * 2 * 3500


def test_bound_of_a_chunk():
    """16384 boards x 256 steps: one instruction a state value a
    board-step at 33.45e12/s (0.106 ms) outweighs the bytes (0.034 ms)."""
    assert H100.issue == pytest.approx(33.45e12, rel=1e-3)
    ops = 16384 * 256 * 7 * 121 / H100.issue
    assert peaks.bound_s(16384 * 256, peaks.chunk_bytes(16384, "harmless"),
                         H100) == ops
    assert ops == pytest.approx(0.106e-3, rel=0.01)
    byte_bound = peaks.bound_s(1, 10**9, H100)
    assert byte_bound == 10**9 / peaks.HBM_BYTES_PER_S


def test_roofline_reader():
    rec = Record(rates=H100, roofline={"kernel": "rollout_chunk_kernel",
                                       "board_steps": 16384 * 256,
                                       "bytes": peaks.chunk_bytes(16384,
                                                                  "simple")})
    rec.ops = [("rollout_chunk_kernel<true>", 0.0, 0.02),
               ("rollout_chunk_kernel<true>", 0.03, 0.05),
               ("env_merge_kernel", 0.05, 0.06)]
    least = 16384 * 256 * 7 * 121 / H100.issue
    assert chunk_roofline_pct.read(rec, "") == pytest.approx(
        100 * least / 0.02)
    rec.ops = [("env_merge_kernel", 0.0, 1.0)]
    assert chunk_roofline_pct.read(rec, "") is None


def test_no_share_can_pass_its_peak():
    """The bound is a floor: a kernel time at the bound reads 100%."""
    rec = Record(rates=H100, roofline={"kernel": "k", "board_steps": 1000,
                                       "bytes": 0})
    t = peaks.bound_s(1000, 0, H100)
    rec.ops = [("k", 0.0, t)]
    assert chunk_roofline_pct.read(rec, "") == pytest.approx(100.0)
