"""Time warp reductions (redux.sync) beside lane shuffles and adds on the card.

    python tools/redux_rate.py [--ctas-per-sm N]

Builds the small CUDA source below with ``nvcc`` into ``build/`` and times
one kernel per instruction with CUDA events, on ``N`` CTAs of 4 warps an SM
(default 16; 4 shows whether the rate depends on occupancy): every lane
runs 4096 iterations of 8 independent chains of ``x = op(x) + j``, where
``op`` is ``__reduce_add_sync`` (REDUX.SUM), ``__reduce_min_sync`` on int
(REDUX.MIN.S32) or ``__shfl_xor_sync`` (SHFL.BFLY, whose rate is known: one
warp instruction a clock per SM).  Prints the card's name and power limit,
then one JSON object an instruction: ``{"op", "ms", "warp_ops",
"per_sm_clock"}``, where ``per_sm_clock`` is the chains' steps (one ``op``
and one add each) a clock and SM at the card's maximum SM clock
(``device.card_rates``).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

SOURCE = r"""
#include <cuda_runtime.h>

template <int OP>
__global__ void __launch_bounds__(128) rate_kernel(unsigned* out, int iters) {
  unsigned x[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = threadIdx.x * (j + 1);
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      unsigned y = x[j];
      if constexpr (OP == 0) y = __reduce_add_sync(0xffffffffu, y);
      if constexpr (OP == 1) y = (unsigned)__reduce_min_sync(0xffffffffu, (int)y);
      if constexpr (OP == 2) y = __shfl_xor_sync(0xffffffffu, y, 1);
      x[j] = y + (unsigned)(j + i);
    }
  }
  unsigned s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s ^= x[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int rate_run(int op, int ctas, int iters, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  unsigned* o = (unsigned*)out;
  if (op == 0) rate_kernel<0><<<ctas, 128, 0, s>>>(o, iters);
  if (op == 1) rate_kernel<1><<<ctas, 128, 0, s>>>(o, iters);
  if (op == 2) rate_kernel<2><<<ctas, 128, 0, s>>>(o, iters);
  return (int)cudaGetLastError();
}
"""
OPS = ("redux.add", "redux.min.s32", "shfl.bfly")
ITERS = 4096


def build() -> ctypes.CDLL:
    from pomcpp_tpu_torch import _ext

    out_dir = HERE / "build" / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(SOURCE.encode()).hexdigest()[:16]
    lib = out_dir / f"libredux_rate_{tag}.so"
    if not lib.exists():
        src = out_dir / f"redux_rate_{tag}.cu"
        src.write_text(SOURCE)
        flags = [f for f in _ext.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        subprocess.run([_ext.nvcc(), *flags, "-o", str(lib), str(src)],
                       check=True)
    handle = ctypes.CDLL(str(lib))
    handle.rate_run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p, ctypes.c_void_p]
    return handle


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ctas-per-sm", type=int, default=16)
    args = ap.parse_args(argv)

    import torch

    from pomcpp_tpu_torch.device import card_rates

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    lib = build()
    rates = card_rates()
    ctas = rates.sms * args.ctas_per_sm
    out = torch.empty(ctas * 128, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {smi}; {ctas} CTAs of 4 warps, {ITERS} iterations "
          f"of 8 chains")
    for op, name in enumerate(OPS):
        def launch():
            err = lib.rate_run(op, ctas, ITERS, out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"launch failed ({err})")

        launch()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(5):
            launch()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 5
        steps = ctas * 4 * ITERS * 8
        print(json.dumps({
            "op": name, "ms": ms, "warp_ops": steps,
            "per_sm_clock": steps / (ms * 1e-3 * rates.sms
                                     * rates.clock_mhz * 1e6)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
