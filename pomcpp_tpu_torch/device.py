"""Device selection shared by every entry point of the port, the card's
rates that a bound divides by, and a device timer."""

from __future__ import annotations

import functools
import subprocess
from typing import NamedTuple

import torch

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 memory rate
TF32_OPS_PER_S = 495e12      # H100 SXM TF32 tensor-core dense peak
ISSUE_LANES = 128            # 32-bit instructions a clock per SM (4 x 32 lanes)
SHUFFLE_LANES = 32           # warp shuffle results a clock per SM
L2_FLUSH_BYTES = 64 << 20    # above the H100's 50 MB L2
HOLD_CYCLES = 20_000_000     # about 10 ms of the card's clock


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; a missing card is an error, never a CPU run.

    The CPU is used only when the caller names it (``device="cpu"``).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "PyTorch version on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is absent")
    return device


class Rates(NamedTuple):
    """The card's ceilings that a bound divides by."""
    sms: int
    clock_mhz: float     # the SM clock's maximum
    issue: float         # 32-bit instructions a second: 128 lanes x SMs x clock
    shuffle: float       # lane shuffles a second: 32 x SMs x clock
    hbm: float = HBM_BYTES_PER_S
    tf32: float = TF32_OPS_PER_S


@functools.lru_cache(maxsize=None)
def card_rates(index: int = 0) -> Rates:
    """Rates of card ``index``: its SM count from the CUDA runtime, its
    maximum SM clock from ``nvidia-smi``."""
    props = torch.cuda.get_device_properties(index)
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = props.multi_processor_count
    return Rates(sms, mhz, ISSUE_LANES * sms * mhz * 1e6,
                 SHUFFLE_LANES * sms * mhz * 1e6)


def rates_line(r: Rates) -> str:
    return (f"{r.sms} SMs at {r.clock_mhz:.0f} MHz: issue {r.issue:.4g}/s, "
            f"shuffles {r.shuffle:.4g}/s, memory {r.hbm:.4g} B/s, "
            f"TF32 {r.tf32:.4g}/s")


@functools.lru_cache(maxsize=None)
def _l2_scratch(device) -> torch.Tensor:
    # Never written: a read of it leaves no dirty line in the L2.
    return torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=device)


def time_device(fn, device, reps: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` (after one warm-up call), from a
    cold L2: each of ``reps`` calls runs after a read of 64 MB, which evicts
    the L2 and leaves it holding clean lines only (a write would leave dirty
    lines for the timed call to write back), and between two CUDA events of
    its own, queued while the stream is held busy (``torch.cuda._sleep``)
    so that the host's time per call stays out of the reading."""
    scratch = _l2_scratch(torch.device(device))
    scratch.amax()
    fn()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    for start, end in marks:
        scratch.amax()
        start.record()
        fn()
        end.record()
    marks[-1][1].synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / reps


def method_floor(device, reps: int = 3) -> dict:
    """What ``time_device`` reads for no work: an empty kernel
    (``torch.cuda._sleep(0)``) and a bare copy of 8 MB into 8 MB (16 MB
    moved, a probe plane's bytes), in milliseconds."""
    device = torch.device(device)
    src = torch.ones(8 << 20, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    return {"empty_ms": time_device(lambda: torch.cuda._sleep(0), device, reps),
            "copy_16mb_ms": time_device(lambda: dst.copy_(src), device, reps)}
