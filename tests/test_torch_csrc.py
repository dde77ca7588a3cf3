"""The port's CUDA sources, checked without a card.

Three kinds of test:

* source hygiene -- every header a ``.cu`` includes is hashed into its
  library's file name (an edited header must trigger a rebuild), the
  warp-layout code holds no CTA-wide barrier, and the launch grid covers
  the batch;
* the chunk kernel's OWN source run on the CPU: ``csrc/host_emu`` stands in
  for ``cuda_runtime.h``, g++ compiles ``fused_step.cu`` as plain C++, and a
  warp runs as 32 fibers that meet at every ``*_sync`` intrinsic.  Results
  are held bit for bit (tolerance: exact equality, all state is integer)
  against ``rollout_chunk_plain``, which ``tests/test_torch_chunk.py`` and
  ``tests/test_torch_fsm.py`` hold against the JAX functions;
* the emulator itself: it must report an intrinsic reached by only part of
  a warp instead of hanging or passing.
"""

import ctypes
import re
import shutil
import subprocess

import pytest
import torch

import chip_smoke
from pomcpp_tpu_torch import _ext
from pomcpp_tpu_torch.convert import diff_fields
from pomcpp_tpu_torch.core.board_gen import random_cell_state
from pomcpp_tpu_torch.engine import fused_step as fs
from pomcpp_tpu_torch.engine.fsm import simple_fsm_state_init

CSRC = _ext.CSRC
WARP_HEADERS = ("step_warp.cuh", "fsm_warp.cuh")
CTA_BARRIER = re.compile(
    r"__syncthreads|bar\.sync|barrier\.sync|__cluster|cooperative_groups"
    r"|cuda::barrier|mbarrier")


def _strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def _includes(name: str, seen=None) -> set:
    """Every quoted include of ``csrc/name``, followed transitively."""
    seen = set() if seen is None else seen
    for inc in re.findall(r'#include\s+"([^"]+)"', (CSRC / name).read_text()):
        if inc not in seen:
            seen.add(inc)
            _includes(inc, seen)
    return seen


@pytest.mark.parametrize("library", sorted(_ext.LIBRARIES))
def test_every_included_header_is_hashed_into_the_build(library):
    source, headers = _ext.LIBRARIES[library]
    assert _includes(source) == set(headers)


def test_every_cu_file_is_a_library():
    assert {p.name for p in CSRC.glob("*.cu")} == \
        {source for source, _ in _ext.LIBRARIES.values()}


@pytest.mark.parametrize("header", WARP_HEADERS)
def test_warp_layout_header_has_no_cta_barrier(header):
    code = _strip_comments((CSRC / header).read_text())
    assert not CTA_BARRIER.search(code)
    assert "__shfl" in code or "__ballot_sync" in code


def _chunk_kernel_source() -> str:
    code = _strip_comments((CSRC / "fused_step.cu").read_text())
    start = code.index("rollout_chunk_kernel(")
    return code[start:code.index("fsm_act_kernel(", start)]


def test_chunk_kernel_runs_the_warp_layout_without_a_cta_barrier():
    body = _chunk_kernel_source()
    assert not CTA_BARRIER.search(body)
    assert "wl::step_board(" in body and "wl::fsm_act(" in body
    # It calls nothing of the CTA layout: those bodies synchronise the CTA.
    assert not re.search(r"(?<!wl::)\b(step_board|fsm_act)\(", body)
    assert "Shared sh" not in body


def test_chunk_grid_is_the_launchers():
    """Both chunk launchers start the grid that ``pomcpp_chunk_grid``
    reports, for ``CHUNK_WARPS`` warps a CTA, and a warp past the end of
    the batch returns."""
    code = _strip_comments((CSRC / "fused_step.cu").read_text())
    assert "return (batch + CHUNK_WARPS - 1) / CHUNK_WARPS;" in code
    assert code.count("pomcpp::chunk_grid(batch)") == 3
    assert code.count("pomcpp::CHUNK_WARPS * 32, stream") == 2
    assert "blockIdx.x * CHUNK_WARPS + warp" in _chunk_kernel_source()
    assert "if (b >= batch) return;" in _chunk_kernel_source()


FAKE_NVCC = """#!/bin/sh
# Stands in for nvcc: writes the file named after -o, prints a ptxas log.
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
: > "$out"
echo "ptxas info    : Compiling entry function \
'_ZN6pomcpp20rollout_chunk_kernelILb0EEEvNS_9StateViewE' for 'sm_90a'"
echo "ptxas info    : 0 bytes stack frame, 0 bytes spill stores, \
0 bytes spill loads"
echo "ptxas info    : Used 128 registers, 2048 bytes smem"
"""


class _Residency:
    """The residency queries of a loaded library."""

    def pomcpp_chunk_warps(self):
        return 4

    def pomcpp_chunk_ctas_per_sm(self, simple):
        return 4


def test_build_log_describes_a_library_built_by_an_earlier_run(
        tmp_path, monkeypatch):
    """A second run finds the libraries built and starts no compiler; it
    still reports the compiler's resources for them, and the residency rows
    do not depend on that log."""
    fake = tmp_path / "nvcc"
    fake.write_text(FAKE_NVCC)
    fake.chmod(0o755)
    monkeypatch.setattr(_ext, "BUILD_DIR", tmp_path / "torch_ext")
    monkeypatch.setattr(_ext, "nvcc", lambda: str(fake))
    assert _ext.build_log() == ""
    outs = _ext.build()
    assert all(out.exists() for out in outs.values())
    first = _ext.build_log()
    assert "Used 128 registers" in first

    def no_compiler():
        raise AssertionError("a built library was compiled again")

    monkeypatch.setattr(_ext, "nvcc", no_compiler)
    assert _ext.build() == outs
    assert _ext.build_log() == first
    res = chip_smoke.chunk_residency(
        chip_smoke.kernel_resources(_ext.build_log(("kernels",))),
        _Residency())
    assert res["rollout_chunk_kernel"] == dict(
        registers=128, stack_bytes=0, spill_store_bytes=0,
        spill_load_bytes=0, smem_bytes=2048, warps_per_cta=4, ctas_per_sm=4,
        boards_per_sm=16)
    # A build with the phase clocks is a library, and a log, of its own.
    assert _ext.build_log(("kernels",), chip_smoke.PHASE_CLOCKS) == ""
    empty = chip_smoke.chunk_residency(chip_smoke.kernel_resources(""),
                                       _Residency())
    assert empty["rollout_chunk_simple_kernel"]["boards_per_sm"] == 16


# --- the kernel's source on the CPU ---------------------------------------------


def _host_build(tmp_path_factory, source, name):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ for the host build of the kernel source")
    out = tmp_path_factory.mktemp("host_emu") / name
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-Wno-unknown-pragmas",
         "-I", str(CSRC / "host_emu"), "-I", str(CSRC), "-x", "c++",
         str(source), "-o", str(out)],
        check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return _ext.bind_kernels(
        _host_build(tmp_path_factory, CSRC / "fused_step.cu", "libhost.so"))


@pytest.mark.parametrize("batch", [1, 3, 4, 5, 16383, 16384])
def test_chunk_grid_covers_the_batch(host_lib, batch):
    grid, warps = host_lib.pomcpp_chunk_grid(batch), host_lib.pomcpp_chunk_warps()
    assert grid * warps >= batch > (grid - 1) * warps


def test_host_build_launches_are_not_counted(host_lib):
    """``LAUNCHES`` counts launches on the card, at the launch; the host
    build of the kernel's source on CPU tensors is none."""
    _ext.reset_launches()
    cs, _ = _batch(2, 1)
    _both(host_lib, cs, 7, 2, "random")
    _both(host_lib, cs, 7, 2, "simple",
          fsm_state=simple_fsm_state_init(2, "cpu"))
    assert not any(_ext.LAUNCHES.values())
    with pytest.raises(ValueError, match="not on a cuda device"):
        fs._rollout_chunk_launch(host_lib, 0, cs, 7, 2, 6, None, False, True,
                                 None, None, (), False)


def _batch(b, seed):
    gen = torch.Generator().manual_seed(seed)
    cs = random_cell_state(b, generator=gen)
    kick = torch.rand((b, 4), generator=gen) < 0.5
    return cs._replace(agent_can_kick=kick), gen


def _both(host_lib, cs, seed, steps, policy, **kw):
    args = dict(moves=None, record=True, auto_reset=True, reset_boards=None,
                fsm_state=None, inject_slots=(), prng_rand=False)
    args.update(kw)
    k = fs._rollout_chunk_launch(host_lib, None, cs, seed, steps,
                                 fs.POLICY_MOVES[policy], **args)
    p = fs.rollout_chunk_plain(cs, seed, steps, policy, **args)
    return k, p


def _same(k, p):
    assert not diff_fields(k[0], p[0], skip=())
    assert torch.equal(k[1], p[1]) and torch.equal(k[2], p[2])
    for a, b in zip(k[3:4] and k[3], p[3:4] and p[3]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy,b,steps", [
    ("harmless", 1, 24), ("harmless", 3, 24), ("harmless", 61, 48),
    ("random", 1, 40), ("random", 3, 40), ("random", 5, 40),
    ("random", 161, 64),
])
def test_chunk_source_matches_plain(host_lib, policy, b, steps):
    cs, _ = _batch(b, 100 + b)
    _same(*_both(host_lib, cs, 7, steps, policy))


def test_chunk_source_matches_plain_with_hooks(host_lib):
    b, steps = 64, 48
    cs, gen = _batch(b, 5)
    dead = torch.zeros((b, 4), dtype=torch.bool)
    dead[:8, 1:] = True          # finished at entry
    dead[8:16, 2:] = True        # two agents left
    cs = cs._replace(agent_dead=dead,
                     alive_count=4 - dead.sum(1, dtype=torch.int32))
    moves = torch.randint(0, 6, (steps, b, 4), generator=gen, dtype=torch.int32)
    fresh = random_cell_state(b, generator=gen)
    k, p = _both(host_lib, cs, 3, steps, "random", moves=moves,
                 reset_boards=(fresh.board, fresh.hidden_pow))
    _same(k, p)
    assert int(p[2].sum()) > 0
    k, p = _both(host_lib, cs, 3, steps, "random", moves=moves,
                 auto_reset=False)
    _same(k, p)


def _copies(cs, n):
    return type(cs)(*(t.expand((n,) + t.shape[1:]).contiguous() for t in cs))


@pytest.mark.parametrize("policy", ["random", "simple"])
def test_chunk_source_matches_plain_on_every_joint_move_with_kicks(host_lib,
                                                                   policy):
    n, steps = 6 ** 4, 4
    codes = torch.arange(n)
    gen = torch.Generator().manual_seed(3)
    moves = torch.randint(0, 6, (steps, n, 4), generator=gen, dtype=torch.int32)
    moves[0] = torch.stack([(codes // 6 ** i) % 6 for i in range(4)], 1).int()
    kw = dict(moves=moves, auto_reset=False)
    if policy == "simple":   # the FSM acts, then every lane is overridden
        kw.update(fsm_state=simple_fsm_state_init(n, "cpu"),
                  inject_slots=(0, 1, 2, 3), prng_rand=True)
    # Kick-enabled agents around two bombs: most joint moves set a bomb
    # rolling, which random play rarely does.
    cs = _copies(chip_smoke.kick_heavy_state("cpu"), n)
    k, p = _both(host_lib, cs, 1, steps, policy, **kw)
    _same(k, p)
    assert int(((p[0].bomb_dir != 0) & (p[0].bomb_timer > 0)).sum()) > 100


@pytest.mark.parametrize("dead", [(), (0,), (2,)])
def test_chunk_source_matches_plain_on_every_joint_move_in_a_ring(host_lib,
                                                                  dead):
    """Four agents on a 2x2 square: the moves that chase each other round
    the ring (no movement root), with and without a dead agent in it."""
    from pomcpp_tpu_torch.engine.cellular import empty_cell_state

    n = 6 ** 4
    codes = torch.arange(n)
    moves = torch.stack([(codes // 6 ** i) % 6 for i in range(4)], 1).int()
    cs = empty_cell_state(1, "cpu")
    board = cs.board.clone()
    ring = ((4, 4), (5, 4), (5, 5), (4, 5))
    for i, (x, y) in enumerate(ring):
        board[0, x + 11 * y] = 10 + i
    gone = torch.tensor([[i in dead for i in range(4)]])
    cs = cs._replace(
        board=board,
        agent_x=torch.tensor([[x for x, _ in ring]], dtype=torch.int32),
        agent_y=torch.tensor([[y for _, y in ring]], dtype=torch.int32),
        agent_dead=gone, alive_count=4 - gone.sum(1, dtype=torch.int32))
    cs = _copies(cs, n)
    k, p = _both(host_lib, cs, 1, 1, "random", moves=moves[None],
                 auto_reset=False)
    _same(k, p)
    if not dead:    # some joint move turns the whole ring
        turned = (p[0].agent_x != cs.agent_x) | (p[0].agent_y != cs.agent_y)
        assert int(turned.all(1).sum()) > 0


@pytest.mark.parametrize("b,steps,inject", [
    (1, 24, False), (3, 24, False), (5, 24, True), (23, 40, False),
    (22, 40, True),
])
def test_simple_chunk_source_matches_plain(host_lib, b, steps, inject):
    cs, gen = _batch(b, 200 + b)
    kw = dict(fsm_state=simple_fsm_state_init(b, "cpu"))
    if inject:
        kw.update(moves=torch.randint(0, 6, (steps, b, 4), generator=gen,
                                      dtype=torch.int32),
                  inject_slots=(0,), prng_rand=True)
    _same(*_both(host_lib, cs, 9, steps, "simple", **kw))


def test_simple_chunk_source_carries_its_state_across_chunks(host_lib):
    b = 6
    cs, gen = _batch(b, 31)
    rands = torch.randint(0, 5, (16, b, 4), generator=gen, dtype=torch.int32)
    fk = fp = simple_fsm_state_init(b, "cpu")
    ck = cp = cs
    for chunk in range(2):
        k, p = _both(host_lib, ck, 11 + chunk, 16, "simple", fsm_state=fk,
                     moves=rands)
        _same(k, p)
        assert all(torch.equal(a, c) for a, c in zip(fk, fp))
        ck, fk, cp, fp = k[0], k[3], p[0], p[3]


DIVERGENT = r"""
#include <cuda_runtime.h>
__global__ void vote_under_a_lane_condition(int* out) {
  if ((threadIdx.x & 31) < 16) out[threadIdx.x] = __ballot_sync(0xffffffffu, 1);
}
__global__ void vote_by_all(int* out) {
  out[threadIdx.x] = __ballot_sync(0xffffffffu, (threadIdx.x & 1));
}
extern "C" int run(int divergent, int* out) {
  if (divergent) POMCPP_LAUNCH(vote_under_a_lane_condition, 1, 32, 0, out);
  else POMCPP_LAUNCH(vote_by_all, 1, 32, 0, out);
  return cudaGetLastError();
}
"""


def test_host_emulation_reports_a_divergent_intrinsic(tmp_path_factory):
    src = tmp_path_factory.mktemp("divergent") / "divergent.cu"
    src.write_text(DIVERGENT)
    lib = _host_build(tmp_path_factory, src, "libdivergent.so")
    out = (ctypes.c_int * 32)()
    assert lib.run(0, out) == 0
    assert [v & 0xFFFFFFFF for v in out] == [0xAAAAAAAA] * 32
    assert lib.run(1, out) != 0
