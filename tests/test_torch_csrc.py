"""The port's CUDA sources, checked without a card.

Three kinds of test:

* source hygiene -- every header a ``.cu`` includes is hashed into its
  library's file name (an edited header must trigger a rebuild), only
  ``launch.py`` calls the engine and feature libraries, the kernels hold
  one board per warp and no CTA-wide barrier, and the launch grid covers
  the batch;
* the warp-layout kernels' OWN source run on the CPU: ``csrc/host_emu``
  stands in for ``cuda_runtime.h``, g++ compiles ``fused_step.cu`` as plain
  C++, and a warp runs as 32 fibers that meet at every ``*_sync``
  intrinsic.  Results are held bit for bit (tolerance: exact equality, all
  state is integer) against the plain versions -- the chunk kernel against
  ``rollout_chunk_plain``, the step kernel against ``fused_step_plain``,
  the act kernel against ``fsm_act_plain``, the env kernels against the env
  functions on CPU tensors -- which ``tests/test_torch_chunk.py``,
  ``test_torch_fsm.py``, ``test_torch_fused_step.py`` and
  ``test_torch_env.py`` hold against the JAX functions;
* the probes' layout="warp" designs (``csrc/probe_warp.cuh``) through a
  small C binding: every elem, shift, reduce and ``dotred`` pattern but
  ``any_plane`` (which needs the CTA) against its plain version, bit for
  bit, and each pattern's shuffles and warp reductions per lane counted
  against the exchange its design claims;
* the feature kernel's own source (``features.cu``, the actor-critic's
  egocentric features in bf16) against ``ego_features_plain`` bit for bit,
  on fresh and played games, into new blocks and trajectory rows at every
  alignment; its float32 scalars against both the CPU's division and the
  card's reciprocal product; and the PPO collector with the source in the
  plain version's place;
* the emulator itself: it must report an intrinsic reached by only part of
  a warp instead of hanging or passing, and its signed reductions and
  float shuffles must be the card's.
"""

import ctypes
import functools
import re
import shutil
import subprocess

import pytest
import torch

import chip_smoke
from pomcpp_tpu_torch import _ext, launch, probes, trace
from pomcpp_tpu_torch.convert import diff_fields
from pomcpp_tpu_torch.core.board_gen import random_cell_state
from pomcpp_tpu_torch.engine import fused_step as fs
from pomcpp_tpu_torch.engine.cellular import empty_cell_state
from pomcpp_tpu_torch.engine.fsm import fsm_act_plain, simple_fsm_state_init
from pomcpp_tpu_torch.env import environment as env
from pomcpp_tpu_torch.learner import ppo as tppo
from pomcpp_tpu_torch.models.features import ego_features_plain

CSRC = _ext.CSRC
WARP_HEADERS = ("step_warp.cuh", "fsm_warp.cuh", "env_warp.cuh",
                "probe_warp.cuh")
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


def test_every_header_in_csrc_is_in_a_library():
    listed = {h for _, headers in _ext.LIBRARIES.values() for h in headers}
    assert {p.name for p in CSRC.glob("*.cuh")} == listed


class _Entries(dict):
    """Stands in for a loaded library: records each entry a binder
    declares."""

    def __getattr__(self, name):
        return self.setdefault(name, type("Entry", (), {})())


def test_only_the_launch_layer_calls_the_kernel_libraries():
    """No module of the package but ``launch.py`` names an entry of the
    engine or feature library (``_ext`` declares them, ``probes.py`` calls
    its own library's), and one function, ``launch.card``, reads the card's
    stream for them: the four entry points choose by it alone."""
    entries = set(_ext.bind_kernels(_Entries())) | \
        set(_ext.bind_features(_Entries()))
    assert "pomcpp_env_merge" in entries and "pomcpp_ego_features" in entries
    package = CSRC.parent
    callers, streams, switches = set(), set(), set()
    for path in package.rglob("*.py"):
        code = path.read_text()
        name = path.relative_to(package).as_posix()
        if set(re.findall(r"\b\w+\.(pomcpp_\w+)", code)) & entries and \
                name != "_ext.py":
            callers.add(name)
        if "current_stream(" in code:
            streams.add(name)
        if "launch.card(" in code:
            switches.add(name)
    assert callers == {"launch.py"}
    assert streams == {"launch.py", "probes.py"}
    assert switches == {"engine/fused_step.py", "engine/fsm.py",
                        "env/environment.py", "models/features.py"}


def test_the_cta_layout_is_gone():
    """No kernel of ``fused_step.cu`` holds one board per CTA: the headers
    of that layout are deleted and every kernel is launched as
    ``CHUNK_WARPS`` boards of one warp each."""
    assert not (CSRC / "fsm_block.cuh").exists()
    assert not (CSRC / "step_block.cuh").exists()
    code = _strip_comments((CSRC / "fused_step.cu").read_text())
    kernels = re.findall(r"__global__ void (__launch_bounds__\([^)]*\))", code)
    assert len(kernels) == 5
    assert all(k.startswith("__launch_bounds__(CHUNK_WARPS * 32") for k in kernels)
    assert not CTA_BARRIER.search(code)


@pytest.mark.parametrize("header", WARP_HEADERS)
def test_warp_layout_header_has_no_cta_barrier(header):
    code = _strip_comments((CSRC / header).read_text())
    assert not CTA_BARRIER.search(code)
    # Warp intrinsics, or (the env epilogue) the lane layout of a warp's board.
    assert any(k in code for k in ("__shfl", "__ballot_sync", "const Geo& g"))


def _kernel_source(name: str, end: str) -> str:
    """The comment-free source of kernel ``name`` up to ``end``."""
    code = _strip_comments((CSRC / "fused_step.cu").read_text())
    start = code.index(f"{name}(")
    return code[start:code.index(end, start)]


def _chunk_kernel_source() -> str:
    """The chunk kernels' body and the two kernels that instantiate it."""
    return _kernel_source("rollout_chunk_board", "fsm_act_kernel(")


def test_chunk_kernel_runs_the_warp_layout_without_a_cta_barrier():
    body = _chunk_kernel_source()
    assert not CTA_BARRIER.search(body)
    assert "wl::step_board(" in body and "wl::fsm_act(" in body
    # It calls nothing of the CTA layout: those bodies synchronise the CTA.
    assert not re.search(r"(?<!wl::)\b(step_board|fsm_act)\(", body)
    assert "Shared sh" not in body


@pytest.mark.parametrize("kernel,end", [
    ("fused_step_kernel", "env_merge_kernel("),
    ("env_merge_kernel", "rollout_chunk_kernel("),
])
def test_step_and_env_kernels_run_the_warp_layout_without_a_cta_barrier(
        kernel, end):
    body = _kernel_source(kernel, end)
    assert not CTA_BARRIER.search(body)
    assert "blockIdx.x * CHUNK_WARPS" in body and "if (b >= batch) return;" in body
    # A board that was done skips the step, by a warp-uniform vote.
    assert "__any_sync(wl::FULL, ein.done[b] != 0)" in body
    if kernel == "fused_step_kernel":
        assert "wl::step_board(" in body
        assert not re.search(r"(?<!wl::)\bstep_board\(", body)
    if kernel == "env_merge_kernel":    # in place: a running board moves no game
        assert "wl::env_reset_board(b, g, fresh, ein, game, eout," in body
        assert "wl::load_game(" not in body and "wl::store_game(" not in body
        assert "plane[" not in body and "agent[" not in body
    # The shared header holds constants and helpers, no kernel body.
    common = _strip_comments((CSRC / "common.cuh").read_text())
    assert "step_board" not in common and "struct Cell " not in common


def test_fsm_act_kernel_runs_the_warp_body_without_a_cta_barrier():
    body = _kernel_source("fsm_act_kernel", "extern \"C\"")
    assert not CTA_BARRIER.search(body)
    assert "wl::fsm_act(" in body and "wl::FsmSlice" in body
    assert not re.search(r"(?<!wl::)\bfsm_act\(", body)
    assert "blockIdx.x * CHUNK_WARPS + warp" in body
    assert "if (b >= batch) return;" in body
    assert "wl::load_game(in" in body      # the typed state, bools as bytes
    assert "for (" not in body.split("wl::fsm_act(")[1]  # no loop of acts


def test_chunk_grid_is_the_launchers():
    """The chunk, step and env launchers start the grid that
    ``pomcpp_chunk_grid`` reports, for ``CHUNK_WARPS`` warps a CTA, and a
    warp past the end of the batch returns."""
    code = _strip_comments((CSRC / "fused_step.cu").read_text())
    assert "return (batch + CHUNK_WARPS - 1) / CHUNK_WARPS;" in code
    assert "int pomcpp_chunk_grid(int batch) { return pomcpp::chunk_grid(batch); }" \
        in code
    launches = [" ".join(c.split()) for c in
                re.findall(r"(?<!define )POMCPP_LAUNCH\(([^;]*)\);", code)]
    assert len(launches) == 6     # the chunk's plain and clocked instances
    for call in launches:
        assert re.match(r"[\w:<>]+, (pomcpp::)?chunk_grid\(batch\), "
                        r"(pomcpp::)?CHUNK_WARPS \* 32, stream,", call), call
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

    def pomcpp_ctas_per_sm(self, kernel):
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
    res = chip_smoke.warp_residency(
        chip_smoke.kernel_resources(_ext.build_log(("kernels",))),
        _Residency())
    assert res["rollout_chunk_kernel"] == dict(
        registers=128, stack_bytes=0, spill_store_bytes=0,
        spill_load_bytes=0, smem_bytes=2048, warps_per_cta=4, ctas_per_sm=4,
        boards_per_sm=16)
    # The clocked instance lives in the same library: its residency line is
    # read from the same log and the same runtime query as the plain one's.
    assert res["rollout_chunk_clocked_kernel"] == dict(     # no log line
        warps_per_cta=4, ctas_per_sm=4, boards_per_sm=16)
    empty = chip_smoke.warp_residency(chip_smoke.kernel_resources(""),
                                       _Residency())
    assert empty["rollout_chunk_simple_kernel"]["boards_per_sm"] == 16
    assert empty["fused_env_step_kernel"]["boards_per_sm"] == 16
    assert empty["rollout_chunk_clocked_kernel"]["boards_per_sm"] == 16
    assert empty["rollout_chunk_clocked_simple_kernel"]["boards_per_sm"] == 16
    clocked = chip_smoke.kernel_resources(
        "ptxas info    : Compiling entry function "
        "'_ZN6pomcpp28rollout_chunk_clocked_kernelILb1EEEvNS_9StateViewE' "
        "for 'sm_90a'\nptxas info    : 8 bytes stack frame, 120 bytes spill "
        "stores, 130 bytes spill loads\nptxas info    : Used 128 registers, "
        "8832 bytes smem\n")
    assert clocked == {"rollout_chunk_clocked_simple_kernel": dict(
        registers=128, stack_bytes=8, spill_store_bytes=120,
        spill_load_bytes=130, smem_bytes=8832)}


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
    build of the kernel's source on CPU tensors is none, and it refuses an
    array on any other device, which it cannot read."""
    _ext.reset_launches()
    cs, _ = _batch(2, 1)
    _both(host_lib, cs, 7, 2, "random")
    _both(host_lib, cs, 7, 2, "simple",
          fsm_state=simple_fsm_state_init(2, "cpu"))
    launch.fused_step(host_lib, None, cs, torch.zeros((2, 4)))
    es = env.env_reset(3, 2, device="cpu")
    _env_step(host_lib, es, torch.zeros((2, 4)))
    launch.env_merge(host_lib, None, es[1:], es.game, None, False, 0, False)
    assert not any(_ext.LAUNCHES.values())
    elsewhere = cs._replace(board=cs.board.to("meta"))
    with pytest.raises(ValueError, match="board must be \\[2, 121\\] on a cpu"):
        launch.chunk(host_lib, None, elsewhere, 7, 2)
    with pytest.raises(ValueError, match="board must be \\[2, 121\\] on a cpu"):
        launch.fused_step(host_lib, None, elsewhere, torch.zeros((2, 4)))


def _batch(b, seed):
    gen = torch.Generator().manual_seed(seed)
    cs = random_cell_state(b, generator=gen)
    kick = torch.rand((b, 4), generator=gen) < 0.5
    return cs._replace(agent_can_kick=kick), gen


def _both(host_lib, cs, seed, steps, policy, **kw):
    args = dict(moves=None, record=True, auto_reset=True, reset_boards=None,
                fsm_state=None, inject_slots=(), prng_rand=False)
    args.update(kw)
    k = launch.chunk(host_lib, None, cs, seed, steps, policy, **args)
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


def _joint_moves():
    codes = torch.arange(6 ** 4)
    return torch.stack([(codes // 6 ** i) % 6 for i in range(4)], 1).int()


def _ring(dead):
    """6^4 copies of four agents on a 2x2 square, ``dead`` of them dead."""
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
    return _copies(cs, 6 ** 4)


@pytest.mark.parametrize("dead", [(), (0,), (2,)])
def test_chunk_source_matches_plain_on_every_joint_move_in_a_ring(host_lib,
                                                                  dead):
    """Four agents on a 2x2 square: the moves that chase each other round
    the ring (no movement root), with and without a dead agent in it."""
    cs = _ring(dead)
    k, p = _both(host_lib, cs, 1, 1, "random", moves=_joint_moves()[None],
                 auto_reset=False)
    _same(k, p)
    if not dead:    # some joint move turns the whole ring
        turned = (p[0].agent_x != cs.agent_x) | (p[0].agent_y != cs.agent_y)
        assert int(turned.all(1).sum()) > 0


# --- the step kernel and the env kernels on the CPU -----------------------------


def _step_both(host_lib, cs, moves):
    k = launch.fused_step(host_lib, None, cs, moves)
    p = fs.fused_step_plain(cs, moves)
    assert not diff_fields(k, p, skip=())
    return p


def test_step_source_matches_plain_on_every_joint_move_with_kicks(host_lib):
    """Every 6^4 joint move on the kick-heavy state, two steps deep."""
    cs = _copies(chip_smoke.kick_heavy_state("cpu"), 6 ** 4)
    moves = _joint_moves()
    for _ in range(2):
        cs = _step_both(host_lib, cs, moves)
    assert int(((cs.bomb_dir != 0) & (cs.bomb_timer > 0)).sum()) > 100


@pytest.mark.parametrize("dead", [(), (0,), (2,)])
def test_step_source_matches_plain_on_every_joint_move_in_a_ring(host_lib,
                                                                 dead):
    _step_both(host_lib, _ring(dead), _joint_moves())


@pytest.mark.parametrize("b", [1021, 5, 3, 1])
def test_step_source_matches_plain_on_ragged_batches(host_lib, b):
    """The last CTA of four warps partly or mostly without a board."""
    cs, gen = _batch(b, 300 + b)
    cs = chip_smoke.close_quarters(cs, gen)
    for _ in range(3 if b > 5 else 12):
        mv = torch.randint(0, 6, (b, 4), generator=gen, dtype=torch.int32)
        cs = _step_both(host_lib, cs, mv)


def _env_step(host_lib, es, moves, fresh=None, team_mode=False, max_steps=0,
              randomize_positions=False):
    """``fused_step_kernel<true>``'s source on ``es``."""
    game, rest = launch.env_step(host_lib, None, es[1:], es.game, moves, fresh,
                                 team_mode, max_steps, randomize_positions)
    return env.EnvState(game, *rest)


def _same_env(card, plain, what):
    assert not diff_fields(card.game, plain.game, skip=()), what
    for name in ("done", "winner", "is_draw", "key"):
        a, b = getattr(card, name), getattr(plain, name)
        assert a.dtype == b.dtype and torch.equal(a, b), f"{what}: {name}"


def _env_start(b, done):
    """Boards that win, draw or finish a team at once and boards already
    done (``done="some"``), every board done (``"all"``) or none, from
    fresh games (``"none"``)."""
    if done == "none":
        return env.env_reset(13, b, device="cpu")
    es = chip_smoke.env_held_start(b, 3)
    if done == "all":
        es = es._replace(done=torch.ones(b, dtype=torch.bool))
    return es


ENV_CASES = {
    "ffa": dict(),
    "ffa_max_steps": dict(max_steps=9),
    "team_max_steps": dict(team_mode=True, max_steps=11),
    "randomize_positions": dict(max_steps=9, randomize_positions=True),
}


def _env_kwargs(case):
    kw = dict(team_mode=False, max_steps=0, randomize_positions=False)
    kw.update(ENV_CASES[case])
    return kw


@pytest.mark.parametrize("done", ["none", "some", "all"])
@pytest.mark.parametrize("case", sorted(ENV_CASES) + ["fresh"])
def test_env_step_source_matches_plain(host_lib, case, done):
    """``fused_step_kernel<true>`` against ``env_step_auto_reset_batch(
    fused=True)`` on CPU tensors, every EnvState field after every step."""
    b, steps = 48, 16
    kw = _env_kwargs("team_max_steps" if case == "fresh" else case)
    card = plain = _env_start(b, done)
    gen = torch.Generator().manual_seed(17)
    resets = 0
    for t in range(steps):
        mv = torch.randint(0, 6, (b, 4), generator=gen, dtype=torch.int32)
        fresh = None
        if case == "fresh":     # the test hook: seats drawn, not in order
            fresh = random_cell_state(b, generator=gen,
                                      randomize_positions=True)
        resets += int(plain.done.sum())
        card = _env_step(host_lib, card, mv, fresh, **kw)
        plain = env.env_step_auto_reset_batch(plain, mv, fused=True,
                                              fresh=fresh, device="cpu", **kw)
        _same_env(card, plain, f"{case} step {t}")
    assert resets > 0


def _merge(host_lib, es, game, fresh=None, team_mode=False, max_steps=0,
           randomize_positions=False):
    """``env_merge_kernel``'s source on a copy of ``game``, which it writes
    in place and returns as the merged game."""
    mine = type(game)(*(t.clone() for t in game))
    merged, rest = launch.env_merge(host_lib, None, es[1:], mine, fresh,
                                    team_mode, max_steps, randomize_positions)
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(merged, mine))
    return env.EnvState(merged, *rest)


@pytest.mark.parametrize("done", ["none", "some", "all"])
@pytest.mark.parametrize("case", sorted(ENV_CASES) + ["fresh"])
def test_env_merge_source_matches_plain(host_lib, case, done):
    """``env_merge_kernel`` against ``_merge_done_and_reset`` on a batch
    stepped by the plain one-step simple chunk, as the mixed-control env
    step runs them."""
    b, steps = 48, 12
    kw = _env_kwargs("ffa_max_steps" if case == "fresh" else case)
    card = plain = _env_start(b, done)
    fsm = simple_fsm_state_init(b, "cpu")
    gen = torch.Generator().manual_seed(19)
    for t in range(steps):
        mv = torch.randint(0, 6, (1, b, 4), generator=gen, dtype=torch.int32)
        fresh = None
        if case == "fresh":
            fresh = random_cell_state(b, generator=gen,
                                      randomize_positions=True)
        game, fsm = fs.rollout_chunk_plain(
            plain.game, 40 + t, 1, "simple", moves=mv, auto_reset=False,
            fsm_state=fsm, inject_slots=(0,), prng_rand=True)
        card = _merge(host_lib, card, game, fresh, **kw)
        plain = env._merge_done_and_reset(plain, game, fresh=fresh, **kw)
        _same_env(card, plain, f"{case} step {t}")


@pytest.mark.parametrize("case", ["ffa", "team_max_steps",
                                  "randomize_positions"])
@pytest.mark.parametrize("b", [1, 5, 1021])
def test_env_merge_source_matches_plain_on_ragged_batches(host_lib, b, case):
    """``env_merge_kernel`` with done boards in the middle of a CTA (and
    alone in one), the last CTA partly or mostly without a board."""
    kw = _env_kwargs(case)
    es = env.env_reset(29, b, device="cpu")
    gen = torch.Generator().manual_seed(b)
    dead = torch.rand((b, 4), generator=gen) < 0.3
    done = torch.zeros(b, dtype=torch.bool)
    done[1::4] = True             # warp 1 of every CTA
    done[b // 2] = True
    card = plain = es._replace(game=chip_smoke.kill(es.game, dead), done=done)
    for t in range(2):
        mv = torch.randint(0, 6, (b, 4), generator=gen, dtype=torch.int32)
        game = fs.fused_step_plain(plain.game, mv)
        game = game._replace(timestep=game.timestep + 5)
        card = _merge(host_lib, card, game, **kw)
        plain = env._merge_done_and_reset(plain, game, **kw)
        _same_env(card, plain, f"{case} {b} boards step {t}")


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


# --- the act kernel on the CPU ----------------------------------------------------


def _acts_both(host_lib, cs, acts, seed, fsm=None):
    """``acts`` acts of ``fsm_act_kernel``'s source and of ``fsm_act_plain``
    in a row, the FSM state carried (from ``fsm``, else a fresh one) and the
    board stepped by the plain version between acts; moves and all ten FSM
    arrays held bit for bit."""
    b = cs.board.shape[0]
    gen = torch.Generator().manual_seed(seed)
    fk = fp = simple_fsm_state_init(b, "cpu") if fsm is None else fsm
    for t in range(acts):
        rand = torch.randint(0, 5, (b, 4), generator=gen, dtype=torch.int32)
        mk, fk = launch.fsm_act(host_lib, None, cs, fk, rand)
        mp, fp = fsm_act_plain(cs, fp, rand)
        assert torch.equal(mk, mp), f"moves, act {t}"
        for k, (x, y) in enumerate(zip(fk, fp)):
            assert torch.equal(x, y), f"FSM array {k}, act {t}"
        cs = fs.fused_step_plain(cs, torch.where(cs.agent_dead, 0, mp))
    return fp


@pytest.mark.parametrize("b", [1, 3, 5, 64])
def test_act_source_matches_plain_on_random_states(host_lib, b):
    """Three acts in a row on generated boards, the last CTA partly or
    mostly without a board."""
    cs, gen = _batch(b, 400 + b)
    if b > 1:
        cs = chip_smoke.close_quarters(cs, gen)
    fsm = _acts_both(host_lib, cs, 3, b)
    assert (fsm.rp_count == 3).all()


@pytest.mark.parametrize("state,dead", [
    ("kick_heavy", None), ("ring", ()), ("ring", (0,)), ("ring", (2,)),
])
def test_act_source_matches_plain_on_swept_states(host_lib, state, dead):
    """32 copies, their own rands, two acts: the kick-heavy state (two
    agents next to a bomb, so the danger map and the flee path run) and
    four agents on a 2x2 square, ``dead`` of them dead (their BFS sources
    pruned)."""
    one = chip_smoke.kick_heavy_state("cpu") if state == "kick_heavy" else \
        chip_smoke.ring_state("cpu", dead)
    _acts_both(host_lib, _copies(one, 32), 2, 5)


@pytest.fixture
def every_call_clocked(monkeypatch):
    """Tracing on from empty rows, every chunk call on the clocked
    instance."""
    monkeypatch.setattr(trace, "SAMPLE_EVERY", 1)
    trace.clear()
    trace.enable()
    yield
    trace.disable()
    trace.clear()


@pytest.mark.parametrize("case", sorted(chip_smoke.bfs_need_states("cpu")))
def test_bfs_runs_only_where_a_decision_reads_it(host_lib, every_call_clocked,
                                                  case):
    """Crafted boards (``chip_smoke.bfs_need_states``), 5 copies: two acts of
    the act kernel's source and a one-step simple chunk equal their plain
    versions on moves and all ten FSM arrays, and the chunk's clocked
    instance counts the acts that ran a BFS round, and the rounds after
    each act's first, as the need rule says."""
    cs, fsm, inject, acts, rounds = chip_smoke.bfs_need_states("cpu")[case]
    b = 5
    cs = _copies(cs, b)
    fsm = type(fsm)(*(t.expand(b, 4).contiguous() for t in fsm))
    _acts_both(host_lib, cs, 2, 17, fsm=fsm)
    kw = dict(fsm_state=fsm, auto_reset=False,
              moves=torch.randint(0, 6, (1, b, 4), dtype=torch.int32,
                                  generator=torch.Generator().manual_seed(5)))
    if inject:
        kw.update(inject_slots=inject, prng_rand=True)
    _same(*_both(host_lib, cs, 23, 1, "simple", **kw))
    (row,) = trace.phase_rows()
    assert (row.totals["n_bfs_acts"], row.totals["n_bfs_rounds"]) == \
        (acts * b, rounds * b)


def test_act_marshalling_calls_no_operator_but_allocations(host_lib):
    """On a state in its own dtypes the act's marshalling dispatches no
    PyTorch operator that could launch work (``chip_smoke.device_ops``, the
    card check of ``fsm_act``); int32 flags need two conversions, and the
    check sees them."""
    cs, gen = _batch(5, 9)
    fsm = simple_fsm_state_init(5, "cpu")
    rand = torch.randint(0, 5, (5, 4), generator=gen, dtype=torch.int32)
    assert chip_smoke.device_ops(
        lambda: launch.fsm_act(host_lib, None, cs, fsm, rand)) == []
    flags_i32 = cs._replace(agent_can_kick=cs.agent_can_kick.int(),
                            agent_dead=cs.agent_dead.int())
    ops = chip_smoke.device_ops(
        lambda: launch.fsm_act(host_lib, None, flags_i32, fsm, rand))
    assert len(ops) == 2 and all("_to_copy" in op for op in ops)


def test_philox_takes_counter_words_mod_2_32():
    """The plain Philox takes its counter words mod 2^32, as the kernels'
    ``uint32_t`` casts do: a board id of 5 + 2^32 draws board 5's words."""
    big = fs.philox4x32(5 + 2 ** 32, 7, 3, 0, 1234)
    small = fs.philox4x32(5, 7, 3, 0, 1234)
    assert int(big[0]) == int(small[0]) == 2773061222
    assert all(torch.equal(a, b) for a, b in zip(big, small))


@pytest.mark.parametrize("kernel", ["step", "merge"])
def test_env_sources_match_plain_on_key_columns_above_2_32(host_lib, kernel):
    """Key rows whose board id is 5 + 2^32 (and others above 2^32) and whose
    reset count is at or above 2^32: the reset draws of both env kernels
    equal the plain version's."""
    b = 8
    es = env.env_reset(21, b, device="cpu")
    key = es.key.clone()
    key[:, 1] = 5 + 2 ** 32 + torch.arange(b)
    key[:, 2] = 2 ** 32 + torch.arange(b)
    done = torch.zeros(b, dtype=torch.bool)
    done[::2] = True
    card = plain = es._replace(key=key, done=done)
    gen = torch.Generator().manual_seed(23)
    for t in range(3):
        mv = torch.randint(0, 6, (b, 4), generator=gen, dtype=torch.int32)
        if kernel == "step":
            card = _env_step(host_lib, card, mv, randomize_positions=True)
            plain = env.env_step_auto_reset_batch(
                plain, mv, fused=True, randomize_positions=True, device="cpu")
        else:
            game = fs.fused_step_plain(plain.game, mv)
            game = game._replace(timestep=game.timestep + 1)
            card = _merge(host_lib, card, game, randomize_positions=True)
            plain = env._merge_done_and_reset(plain, game, False, 0, True)
        _same_env(card, plain, f"{kernel} step {t}")
        card = plain = plain._replace(done=done)    # reset again, count + 1
    assert int(plain.key[0, 1]) == 5 + 2 ** 32
    assert int(plain.key[:, 2].min()) >= 2 ** 32


# --- the mixed-control env step's card path on the CPU ---------------------------


# case -> (what the path is handed, env kwargs, learner slots, wrapper_ops a
# step): int64 moves and FSM arrays, or numpy ones, take one conversion
# each, int32 agent flags none, bool flags the chunk's two; the test hooks'
# arrays are taken as they are, and ``rand_moves`` makes the chunk's moves
# in two operations.
FSM_PATH_CASES = {
    "typed": ("as_is", dict(max_steps=5), (0,), 7),
    "int64_moves_and_fsm": ("int64", dict(team_mode=True, max_steps=6),
                            (0, 2), 18),
    "numpy_moves_and_fsm": ("numpy", dict(max_steps=5), (1,), 18),
    "int32_flags": ("flags_i32", dict(max_steps=5, randomize_positions=True),
                    (), 5),
    "rand_moves": ("rands", dict(team_mode=True, max_steps=6), (0, 3), 9),
    "fresh": ("fresh", dict(max_steps=5, randomize_positions=True), (2,), 7),
}


def _handed(es, mv, fsm, form, gen):
    """The inputs of one step in the form a case hands them over, and the
    test hooks it passes."""
    b = mv.shape[0]
    if form == "int64":
        return (es, mv.long(), [t.long() for t in fsm]), {}
    if form == "numpy":
        return (es, mv.long().numpy(), [t.numpy() for t in fsm]), {}
    if form == "flags_i32":
        game = es.game._replace(agent_can_kick=es.game.agent_can_kick.int(),
                                agent_dead=es.game.agent_dead.int())
        return (es._replace(game=game), mv, fsm), {}
    if form == "rands":
        return (es, mv, fsm), dict(rand_moves=torch.randint(
            0, 6, (b, 4), generator=gen, dtype=torch.int32))
    if form == "fresh":
        return (es, mv, fsm), dict(fresh=random_cell_state(
            b, generator=gen, randomize_positions=True))
    return (es, mv, fsm), {}


def host_card(libs: dict):
    """A ``launch.card`` that hands out the host builds ``libs`` (by
    library) in the card's place, and the plain versions for the others."""
    def card(device, library="kernels"):
        return (libs[library], None) if library in libs else None

    return card


def _fsm_path(host_lib, *args, **kw):
    """``env_step_auto_reset_batch_fsm`` on CPU tensors through its card
    path, the host build in the card's place."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(launch, "card", host_card({"kernels": host_lib}))
        return env.env_step_auto_reset_batch_fsm(*args, device="cpu", **kw)


@pytest.mark.parametrize("case", sorted(FSM_PATH_CASES))
@pytest.mark.parametrize("b", [1, 5, 37])
def test_env_fsm_path_matches_plain(host_lib, b, case):
    """The card path of ``env_step_auto_reset_batch_fsm`` (``launch.chunk``
    and ``launch.env_merge``) through the host build against the plain
    version on CPU tensors, over steps in which boards finish (at once, by
    the step cap, or already done) and reset: every game, env and FSM value
    bit for bit, the dtypes too; each step's conversions counted, so every
    other array was taken as it is."""
    form, kw, slots, ops = FSM_PATH_CASES[case]
    es = env.env_reset(31, b, device="cpu")
    gen = torch.Generator().manual_seed(b)
    done = torch.zeros(b, dtype=torch.bool)
    done[1::4] = True
    done[b // 2] = True
    dead = torch.rand((b, 4), generator=gen) < 0.3
    card = plain = es._replace(game=chip_smoke.kill(es.game, dead), done=done)
    fsm_c = fsm_p = simple_fsm_state_init(b, "cpu")
    resets = 0
    for t in range(8):
        mv = torch.randint(0, 6, (b, 4), generator=gen, dtype=torch.int32)
        resets += int(plain.done.sum())
        args, hooks = _handed(card, mv, fsm_c, form, gen)
        before = dict(trace.COUNTERS)
        card, fsm_c = _fsm_path(host_lib, *args, slots, 60 + t, **kw,
                                **hooks)
        assert trace.COUNTERS["wrapper_ops"] - before["wrapper_ops"] == ops
        plain, fsm_p = env.env_step_auto_reset_batch_fsm(
            plain, mv, fsm_p, slots, 60 + t, device="cpu", **kw, **hooks)
        _same_env(card, plain, f"{case} {b} boards step {t}")
        assert all(a.dtype == p.dtype for a, p in zip(card.game, plain.game))
        for k, (x, y) in enumerate(zip(fsm_c, fsm_p)):
            assert x.dtype == y.dtype and torch.equal(x, y), f"FSM {k}, {t}"
    assert resets > 0


def test_env_fsm_path_refuses_a_wrong_device_or_shape(host_lib):
    """The host build reads CPU memory only: an array elsewhere, or of
    another shape, is refused before anything reads it."""
    b = 4
    es = env.env_reset(3, b, device="cpu")
    fsm = list(simple_fsm_state_init(b, "cpu"))
    mv = torch.zeros((b, 4), dtype=torch.int32)
    game = es.game
    bad = [
        ("moves must be \\[4, 4\\] on a cpu", es, mv.to("meta"), fsm),
        ("moves must be", es, mv[:3], fsm),
        ("board must be", es._replace(
            game=game._replace(board=game.board.to("meta"))), mv, fsm),
        ("agent_dead must be", es._replace(
            game=game._replace(agent_dead=game.agent_dead[:, :3])), mv, fsm),
        ("fsm_state rp3 must be", es, mv,
         fsm[:3] + [fsm[3][:, :2]] + fsm[4:]),
        ("ten arrays", es, mv, fsm[:9]),
        ("key must be", es._replace(key=es.key[:, :2]), mv, fsm),
        ("done must be", es._replace(done=es.done.to("meta")), mv, fsm),
        ("timestep must be", es._replace(game=game._replace(
            timestep=game.timestep[:2])), mv, fsm),
    ]
    for match, *args in bad:
        with pytest.raises(ValueError, match=match):
            _fsm_path(host_lib, *args, (0,), 5)
    for match, hooks in [
            ("rand_moves must be", dict(rand_moves=mv.to("meta"))),
            ("rand_moves must be", dict(rand_moves=[[0] * 4] * 3)),
            ("fresh board must be", dict(fresh=game._replace(
                board=game.board[:, :120])))]:
        with pytest.raises(ValueError, match=match):
            _fsm_path(host_lib, es, mv, fsm, (0,), 5, **hooks)
    with pytest.raises(ValueError, match="must name agents 0-3"):
        _fsm_path(host_lib, es, mv, fsm, (4,), 5)
    _fsm_path(host_lib, es, mv, fsm, (0,), 5)


def test_env_fsm_path_calls_no_operator_but_flags_and_outputs(host_lib):
    """On typed inputs the path dispatches exactly 7 PyTorch operators that
    could launch work (``chip_smoke.device_ops``): the bool agent flags'
    two conversions to the chunk's int32 and the five output operations
    (two casts back, the recount's two, the timestep), which are its
    ``wrapper_ops``: the other 28 input arrays are taken as they are.  The
    outputs of a group share one allocation."""
    b = 5
    es = env.env_reset(3, b, device="cpu")
    fsm = simple_fsm_state_init(b, "cpu")
    mv = torch.randint(0, 6, (b, 4), dtype=torch.int32)
    before = dict(trace.COUNTERS)
    out = []
    ops = chip_smoke.device_ops(lambda: out.extend(_fsm_path(
        host_lib, es, mv, fsm, (0,), 5, max_steps=800)))
    assert sorted(ops) == sorted(
        ["aten._to_copy.default"] * 2 + ["aten.ne.Scalar"] * 2 +
        ["aten.sum.dim_IntList", "aten.rsub.Scalar", "aten.add.Tensor"])
    assert trace.COUNTERS["wrapper_ops"] - before["wrapper_ops"] == 7
    (card, fsm2), storage = out, (lambda t: t.untyped_storage().data_ptr())
    assert len({storage(t) for t in card.game[:7]}) == 1
    assert len({storage(t) for t in card.game[7:12]}) == 1
    assert len({storage(t) for t in fsm2}) == 1


# --- probe_dot_tc_kernel's arithmetic on the CPU --------------------------------


def _tf32(x):
    """``cvt.rna.tf32.f32`` on float32 bits: 10 mantissa bits kept, to
    nearest, ties away from zero."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _pieces(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _kept_product(x, w_pieces, d=torch.float64):
    """One product as the kernel forms it: lo(x) hi(w) + hi(x) lo(w) +
    hi(x) hi(w), the products of pieces summed in ``d`` (float64: exactly;
    float32, the kernel's accumulator, is exact on integers below 2^24)."""
    (xh, xl), (wh, wl) = _pieces(x), w_pieces
    return xl.to(d) @ wh.to(d) + xh.to(d) @ wl.to(d) + xh.to(d) @ wh.to(d)


@pytest.mark.parametrize("seed", [None, 5])
def test_dot_pieces_are_exact_on_the_held_inputs(seed):
    """On the script's inputs (``seed=None``: ones and the shift matrix) and
    the seeded ones (integers 0..3), at the script's K: every value stays
    an integer below 2^13, so the kept cross products of the TF32 pieces
    give ``x @ w`` exactly and the chain equals ``probe_dot_plain``."""
    p = next(q for q in probes.PATTERNS if q.op == "dot")
    inputs = probes.pattern_inputs(p, 8, "cpu", seed=seed)
    x, w = inputs["x"], inputs["w"]
    want = probes.probe_dot_plain(x, w, "dot", p.k)
    w_pieces = _pieces(w)
    peak = x.abs().max()
    for _ in range(p.k * 32):
        x = _kept_product(x, w_pieces, torch.float32) + 1.0
        peak = torch.maximum(peak, x.abs().max())
    assert float(peak) < 2 ** 13 and torch.equal(x, want)
    assert torch.equal(want, want.round())


def test_dot_pieces_on_random_floats_stay_within_the_stated_bound():
    """Random floats: the dropped lo(x) lo(w) term and lo's own rounding
    keep a product within 2^-20 of ``|x| @ |w|`` of the exact one (the
    kernel's f32 accumulation adds at most 2^-16 more; the card test holds
    the sum of both, 2^-15)."""
    gen = torch.Generator().manual_seed(7)
    x = torch.rand((64, 128), generator=gen) * 2 - 1
    w = torch.rand((128, 128), generator=gen) * 2 - 1
    exact = x.double() @ w.double()
    scale = x.double().abs() @ w.double().abs()
    err = (_kept_product(x, _pieces(w)) - exact).abs()
    assert bool((err <= 2 ** -20 * scale).all())
    # Without the lo pieces (one TF32 pass) the same bound fails.
    hi = _tf32(x).double() @ _tf32(w).double()
    assert not bool(((hi - exact).abs() <= 2 ** -20 * scale).all())


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


COLLECTIVES = r"""
#include <cuda_runtime.h>
// Per lane: signed min and max of lane - 16, unsigned min of the same bits,
// the float lane / 4 from the lane across (xor 5) and from lane 3.
__global__ void collectives(int* out, float* f) {
  const int t = threadIdx.x & 31;
  out[4 * t] = __reduce_min_sync(0xffffffffu, t - 16);
  out[4 * t + 1] = __reduce_max_sync(0xffffffffu, t - 16);
  out[4 * t + 2] = (int)__reduce_min_sync(0xffffffffu, (unsigned)(t - 16));
  out[4 * t + 3] = (int)__reduce_max_sync(0xffffffffu, (unsigned)t);
  f[2 * t] = __shfl_xor_sync(0xffffffffu, 0.25f * t, 5);
  f[2 * t + 1] = __shfl_sync(0xffffffffu, __int_as_float(0x4B000000 | t) - 8388608.f, 3);
}
extern "C" int run(int* out, float* f, unsigned long long* reduxes) {
  // The emulator's warp is one object for every host build in the process.
  for (int l = 0; l < 32; ++l) emu::warp().reduxes[l] = 0;
  POMCPP_LAUNCH(collectives, 1, 32, 0, out, f);
  for (int l = 0; l < 32; ++l) reduxes[l] = emu::warp().reduxes[l];
  return cudaGetLastError();
}
"""


def test_host_emulation_reduces_signed_and_shuffles_floats(tmp_path_factory):
    """The card's overloads: __reduce_min/max_sync on int order negatives
    below positives (the unsigned ones do not), a float shuffled by
    __shfl_xor_sync / __shfl_sync keeps its bits; each redux.sync counts."""
    src = tmp_path_factory.mktemp("collectives") / "collectives.cu"
    src.write_text(COLLECTIVES)
    lib = _host_build(tmp_path_factory, src, "libcollectives.so")
    out, f = (ctypes.c_int * 128)(), (ctypes.c_float * 64)()
    reduxes = (ctypes.c_ulonglong * 32)()
    assert lib.run(out, f, reduxes) == 0
    assert [out[4 * t:4 * t + 4] for t in range(32)] == [[-16, 15, 0, 31]] * 32
    assert list(f[0::2]) == [0.25 * (t ^ 5) for t in range(32)]
    assert list(f[1::2]) == [3.0] * 32
    assert list(reduxes) == [4] * 32


# --- the probes' warp designs on the CPU ------------------------------------------

PROBE_BINDING = r"""
#include <cuda_runtime.h>
#include "probe_warp.cuh"
using namespace pomcpp_probes;
extern "C" {
int pomcpp_probe_elem(int op, int layout, int elem_size, const void* in, void* out, int n_rows,
                      int width, int k, int rows, int tile, void* stream) {
  if (layout != L_WARP) return ERR_BAD_ARGUMENT;
  return pw::probe_elem(op, elem_size, in, out, n_rows, width, k, rows, tile, stream);
}
int pomcpp_probe_shift(int op, int layout, int elem_size, const void* p_in, void* p_out,
                       const int32_t* a_in, int32_t* a_out, int n_rows, int k, int rows,
                       int tile, void* stream) {
  if (layout != L_WARP) return ERR_BAD_ARGUMENT;
  return pw::probe_shift(op, elem_size, p_in, p_out, a_in, a_out, n_rows, k, rows, tile, stream);
}
int pomcpp_probe_reduce(int op, int layout, const int32_t* p_in, int32_t* p_out,
                        const int32_t* a_in, int32_t* a_out, int n_rows, int k, int rows,
                        int tile, void* stream) {
  if (layout != L_WARP) return ERR_BAD_ARGUMENT;
  return pw::probe_reduce(op, p_in, p_out, a_in, a_out, n_rows, k, rows, tile, stream);
}
int pomcpp_probe_dot(int op, int layout, const void* x_in, const float* w, void* x_out,
                     int n_rows, int k, int rows, int tile, void* stream) {
  if (layout != L_WARP || op != D_DOTRED) return ERR_BAD_ARGUMENT;
  return pw::probe_dotred((const int32_t*)x_in, w, (int32_t*)x_out, n_rows, k, rows, tile,
                          stream);
}
const char* pomcpp_probes_error_string(int err) { return cudaGetErrorString(err); }
// Each lane's shuffles and warp reductions since the last call, by lane index.
void pomcpp_probe_shuffles(unsigned long long* out) {
  for (int l = 0; l < 32; ++l) {
    out[l] = emu::warp().shuffles[l];
    emu::warp().shuffles[l] = 0;
  }
}
void pomcpp_probe_reduxes(unsigned long long* out) {
  for (int l = 0; l < 32; ++l) {
    out[l] = emu::warp().reduxes[l];
    emu::warp().reduxes[l] = 0;
  }
}
}
"""


@pytest.fixture(scope="module")
def probe_lib(tmp_path_factory):
    src = tmp_path_factory.mktemp("probe_binding") / "probe_binding.cc"
    src.write_text(PROBE_BINDING)
    lib = _ext.bind_probes(_host_build(tmp_path_factory, src,
                                       "libprobes_host.so"))
    lib.pomcpp_probe_shuffles.argtypes = [ctypes.c_void_p]
    lib.pomcpp_probe_reduxes.argtypes = [ctypes.c_void_p]
    return lib


def _lane_counts(fn):
    counts = (ctypes.c_ulonglong * 32)()
    fn(counts)
    return list(counts)


def _shuffles(lib):
    return _lane_counts(lib.pomcpp_probe_shuffles)


def _reduxes(lib):
    return _lane_counts(lib.pomcpp_probe_reduxes)


def _warp_run(lib, p, inputs, k, rows=128, tile=128):
    if p.family == "elem":
        return probes._probe_elem_launch(lib, None, inputs["x"], p.op, k,
                                         "warp", rows, tile)
    if p.family == "dot":
        return probes._probe_dot_launch(lib, None, inputs["x"], inputs["w"],
                                        p.op, k, "warp", rows, tile)
    launch = probes._probe_shift_launch if p.family == "shift" \
        else probes._probe_reduce_launch
    return launch(lib, None, inputs["plane"], inputs["agents"], p.op, k,
                  "warp", rows, tile)


def _same_probe(got, want, what):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), what


# Every pattern with a warp design of its own: all but ``dot`` (tensor
# cores, no layout) and ``any_plane`` (the CTA's tile kernel); the tile
# reductions take whole tiles (``test_probe_warp_any4_source_matches_plain``).
WARP_PATTERNS = [p for p in probes.PATTERNS
                 if p.op not in ("dot", "any_plane") and p.op not in probes.TILE_OPS]
# (rows in all, rows, tile, offset): every row live; the first 32 rows of
# each 128; a row count that fills neither the elem kernel's 128-element
# warps nor the agent kernel's 32-row warps nor the plane kernel's 4-row
# CTAs; and the ragged count from inputs that start one element past a
# 16-byte boundary (contiguous views at an offset, which ``.contiguous()``
# leaves as they are: the kernels' element-by-element path).
PROBE_CASES = {"live": (64, 128, 128, 0), "rows32": (128, 32, 128, 0),
               "ragged": (45, 128, 128, 0), "unaligned": (45, 128, 128, 1)}


def _offset_view(t):
    """``t``'s values in a contiguous view that starts one element later
    than a fresh allocation."""
    t = torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)
    assert t.is_contiguous() and t.data_ptr() % 16
    return t


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
@pytest.mark.parametrize("p", WARP_PATTERNS, ids=probes.label)
def test_probe_warp_source_matches_plain(probe_lib, p, case):
    """Every pattern of layout="warp" (the dense element mapping, the plane
    rolls, the warp scan, the agent rows, the redux.sync reductions, the
    lookups, dotred over 8 lanes) against its plain version, bit for bit,
    K = 3."""
    n, rows, tile, offset = PROBE_CASES[case]
    inputs = probes.pattern_inputs(p, n, "cpu", seed=len(probes.label(p)) + n)
    given = {key: _offset_view(t) if offset and t is not None else t
             for key, t in inputs.items()}
    got = _warp_run(probe_lib, p, given, 3, rows, tile)
    want = probes.run_pattern(p, inputs, k=3, plain=True, rows=rows, tile=tile)
    _same_probe(got, want, f"{probes.label(p)} {case}")


@pytest.mark.parametrize("dtype", probes.INT_TYPES, ids=str)
@pytest.mark.parametrize("width", [4, 8, 32, 128, 5])
def test_probe_warp_chain_at_every_width_and_type(probe_lib, width, dtype):
    """The dense mapping at every width the layout script sweeps (and 5,
    whose rows end mid-access), from an array whose first element is not
    16-byte aligned (the kernel's element-by-element path) and from one that
    is, 24 rows of which the first 3 of every 4 are live, K = 2."""
    gen = torch.Generator().manual_seed(width)
    info = torch.iinfo(dtype)
    flat = torch.randint(info.min, info.max, (24 * width + 1,), generator=gen,
                         dtype=torch.int64).to(dtype)
    for x in (flat[1:].view(24, width), flat[:-1].view(24, width)):
        got = probes._probe_elem_launch(probe_lib, None, x, "chain", 2, "warp",
                                        3, 4)
        assert torch.equal(got, probes.probe_elem_plain(x, "chain", 2, 3, 4))
        assert torch.equal(got[3::4], x[3::4])


# redux.sync (__reduce_*_sync) a lane issues per row and iteration.
REDUX_PER_ROW = {"sublane.sumred": 8, "reductions.min_red4": 4}


@pytest.mark.parametrize("name,per_iter", [
    ("sublane.roll", 32), ("i16.roll[int32]", 20), ("i16.roll[int8]", 20),
    ("patterns.push", 5), ("patterns.push_hoist", 5),
    ("reductions.prefix_or", 5), ("patterns.colslice", 0),
    ("patterns.whole4", 0), ("reductions.rot4_all", 0),
    ("sublane.sumred", 0), ("reductions.min_red4", 0),
    ("sublane.dotred", 12), ("reductions.axis1_any", 0),
    ("reductions.any4", 0), ("patterns.onehot_rd", 0),
    ("reductions.packed_sum", 0),
])
def test_probe_warp_shuffles_only_across_lane_groups(probe_lib, name,
                                                     per_iter):
    """Shuffles a lane issues per row and iteration: roll by 1 one (not
    four), roll by 117 four, prefix_or the five rounds of its warp scan (not
    the 28 of seven full rolls), dotred 48 a warp of four rows (three rounds
    a half and a round, not 80), the agent rows, the redux.sync reductions
    and the lookups none; sumred reduces with 8 redux.sync a round's row
    and iteration, min_red4 with 4, every other pattern with none; rows
    that are not live issue none."""
    p = next(q for q in probes.PATTERNS if probes.label(q) == name)
    k, n = 3, 256
    redux = REDUX_PER_ROW.get(name, 0)
    inputs = probes.pattern_inputs(p, n, "cpu", seed=1)
    _shuffles(probe_lib)
    _reduxes(probe_lib)
    _warp_run(probe_lib, p, inputs, k)
    assert _shuffles(probe_lib) == [n * k * per_iter] * 32
    assert _reduxes(probe_lib) == [n * k * redux] * 32
    if p.op in probes.TILE_OPS:
        return                        # whole tiles only
    _warp_run(probe_lib, p, inputs, k, rows=32)
    assert _shuffles(probe_lib) == [n // 4 * k * per_iter] * 32
    assert _reduxes(probe_lib) == [n // 4 * k * redux] * 32


@pytest.mark.parametrize("n,offset", [(128, 0), (384, 0), (256, 1)])
def test_probe_warp_any4_source_matches_plain(probe_lib, n, offset):
    """any4 of layout="warp" (one warp a tile's 512 agents, four warps
    copying its plane) against its plain version, bit for bit, K = 3, on
    whole tiles; with an offset, the element-by-element path."""
    p = next(q for q in probes.PATTERNS if q.op == "any4")
    inputs = probes.pattern_inputs(p, n, "cpu", seed=n + offset)
    # Hits in some tiles only: tile 0's agents all miss at first.
    inputs["agents"][:128] &= ~1
    given = {key: _offset_view(t) if offset else t
             for key, t in inputs.items()}
    got = _warp_run(probe_lib, p, given, 3)
    _same_probe(got, probes.run_pattern(p, inputs, k=3, plain=True), f"any4 {n}")
    with pytest.raises(RuntimeError, match="invalid argument"):
        _warp_run(probe_lib, p, probes.pattern_inputs(p, 130, "cpu", seed=1), 3)
    plane = inputs["plane"]
    with pytest.raises(RuntimeError, match="invalid argument"):
        probes._probe_reduce_launch(probe_lib, None, plane, inputs["agents"],
                                    "any_plane", 3, "warp", 128, 128)


@pytest.mark.parametrize("seed", [0, 1])
def test_probe_warp_dotred_reads_its_column_of_w(probe_lib, seed):
    """dotred with a random 0/1 W (only W[:, 0] counts), random x and a
    ragged row count, bit for bit: the kernel reads the column it is given
    and does not assume ones (every partial sum stays an integer below
    2^24)."""
    p = next(q for q in probes.PATTERNS if q.op == "dotred")
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(-2 ** 31, 2 ** 31, (128, 128), generator=gen,
                      dtype=torch.int64).to(torch.int32)
    w = torch.randint(0, 2, (128, 128), generator=gen).to(torch.float32)
    assert 0 < int(w[:, 0].sum()) < 128
    got = _warp_run(probe_lib, p, {"x": x, "w": w}, 3, rows=40, tile=64)
    assert torch.equal(got, probes.probe_dot_plain(x, w, "dotred", 3, 40, 64))
    got = _warp_run(probe_lib, p, {"x": x[:70], "w": w}, 3)
    assert torch.equal(got, probes.probe_dot_plain(x[:70], w, "dotred", 3))
    ones = _warp_run(probe_lib, p, {"x": x[:70], "w": torch.ones_like(w)}, 3)
    assert not torch.equal(got, ones)


def test_probe_warp_onehot_reads_off_the_row_as_zero(probe_lib):
    """onehot_rd's lookups at agents -3..-1 and 128..130 (off the row: the
    one-hot max is 0) and on cells of negative value (the max with the
    row's zeros), bit for bit, K = 1 and 3."""
    p = next(q for q in probes.PATTERNS if q.op == "onehot_rd")
    gen = torch.Generator().manual_seed(5)
    plane = torch.randint(-300, 300, (64, 128), generator=gen,
                          dtype=torch.int64).to(torch.int32)
    edges = torch.tensor([-3, -2, -1, 128, 129, 130, 0, 127], dtype=torch.int32)
    agents = edges[torch.randint(0, 8, (64, 4), generator=gen)]
    assert (plane < 0).any() and (agents < 0).any() and (agents >= 128).any()
    for k in (1, 3):
        got = _warp_run(probe_lib, p, {"plane": plane, "agents": agents}, k)
        want = probes.probe_reduce_plain(plane, agents, "onehot_rd", k)
        _same_probe(got, want, f"onehot_rd edges k={k}")
    first = probes.probe_reduce_plain(plane, agents, "onehot_rd", 1)[1]
    assert ((first == 0) | (agents >= 0)).all() and (first[agents >= 128] == 0).all()


def test_probe_warp_header_has_no_asm_and_maps_elements_densely():
    code = _strip_comments((CSRC / "probe_warp.cuh").read_text())
    assert "asm" not in code
    # dotred makes floats of its 16-bit halves with a permute or a
    # shift-and-add and an FADD, never an int -> float conversion.
    dotred = code[code.index("probe_dotred_warp_kernel("):]
    dotred = dotred[:dotred.index("\n}\n")]
    assert "(float)" not in dotred and "__int2float" not in dotred
    assert "__int_as_float(__byte_perm(v[c], 0x4B00, 0x5410))" in dotred
    assert "__int_as_float((v[c] >> 16) + 0x4B400000)" in dotred
    # The elem grid follows the rows x width elements, not rows x 128 lanes.
    assert "const long long n = (long long)n_rows * width;" in code
    assert "(n + (long long)NT * EPT - 1) / ((long long)NT * EPT)" in code
    assert '#include "probe_warp.cuh"' in (CSRC / "probes.cu").read_text()


# --- the feature kernel's source on the CPU -------------------------------------

FEATURE_SLOTS = [(0,), (1, 3), (0, 1, 2, 3)]


@pytest.fixture(scope="module")
def features_lib(tmp_path_factory):
    return _ext.bind_features(_host_build(
        tmp_path_factory, CSRC / "features.cu", "libfeatures.so"))


@pytest.fixture(scope="module")
def feature_states():
    return chip_smoke.feature_states(torch.device("cpu"), 37, 3)


def _bits(t):
    return t.view(torch.int16)


def test_feature_kernel_stages_a_warp_and_stores_whole_vectors():
    """One cell a lane, staged in the warp's shared memory behind a
    ``__syncwarp`` (no CTA barrier), then 16-byte stores."""
    code = _strip_comments((CSRC / "features.cu").read_text())
    assert not CTA_BARRIER.search(code)
    assert code.count("__syncwarp()") == 1
    assert "reinterpret_cast<uint4*>(dst)[q] = vec;" in code


@pytest.mark.parametrize("view_range", [4, 2])
@pytest.mark.parametrize("slots", FEATURE_SLOTS, ids=str)
@pytest.mark.parametrize("state", ["reset", "random", "simple", "edges"])
def test_feature_source_matches_plain(features_lib, feature_states, state,
                                      slots, view_range):
    """The kernel's output equals ``obs_to_features(observe_ego(...))`` bit
    for bit, into a new block and into a trajectory row of a larger buffer
    (37 boards: the row starts off a 16-byte boundary), whose other rows
    it leaves alone."""
    game = feature_states[state]
    want = ego_features_plain(game, slots, view_range)
    got = launch.ego_features(features_lib, None, game, slots, view_range)
    assert torch.equal(_bits(got), _bits(want))
    traj = torch.full((3,) + tuple(want.shape), -7.0, dtype=torch.bfloat16)
    row = launch.ego_features(features_lib, None, game, slots, view_range,
                               out=traj[1])
    assert row.data_ptr() == traj[1].data_ptr() and row.data_ptr() % 16
    assert torch.equal(_bits(traj[1]), _bits(want))
    assert (traj[0] == -7).all() and (traj[2] == -7).all()


def test_feature_source_on_every_alignment_and_a_tiny_batch(features_lib,
                                                           feature_states):
    """Rows written from each of the eight bf16 offsets to a 16-byte
    boundary, one board and a board count that is no multiple of 8."""
    game = feature_states["simple"]
    for b in (1, 3):
        part = type(game)(*(t[:b].contiguous() for t in game))
        want = ego_features_plain(part, (2, 0), 4)
        flat = torch.zeros(want.numel() + 16, dtype=torch.bfloat16)
        for off in range(8):
            out = flat[off:off + want.numel()].view(want.shape)
            launch.ego_features(features_lib, None, part, (2, 0), 4, out=out)
            assert torch.equal(_bits(out), _bits(want)), (b, off)


def test_feature_source_divides_as_the_card_and_the_cpu(features_lib):
    """For every integer 0-1023 and each divisor (10: the bomb timer and
    strength, own strength and position; 4: bomb direction, flame timer; 5:
    max bombs and bomb count) the kernel's bf16 equals both the exact
    float32 quotient rounded to bf16 (the CPU's plain path) and the product
    with the float32 reciprocal rounded to bf16 (the card's)."""
    v = torch.arange(1024, dtype=torch.int32)

    def rounded(d):
        exact = (v.float() / torch.tensor(float(d))).to(torch.bfloat16)
        recip = (v.float() * (1.0 / torch.tensor(float(d)))).to(torch.bfloat16)
        assert torch.equal(_bits(exact), _bits(recip))
        return _bits(exact)

    # The planes: 9 boards of 121 cells hold 0-1088; a window of range 10
    # around (5, 5) covers the whole board.
    g = empty_cell_state(9, "cpu")
    vals = torch.arange(9 * 121, dtype=torch.int32).reshape(9, 121) % 1024
    five = torch.full((9, 4), 5, dtype=torch.int32)
    g = g._replace(bomb_timer=vals, bomb_strength=vals, bomb_dir=vals,
                   flame_timer=vals, agent_x=five, agent_y=five)
    out = launch.ego_features(features_lib, None, g, (0,), 10)
    cells = out.reshape(9, 21, 21, 23)[:, 5:16, 5:16].reshape(9 * 121, 23)
    first = torch.arange(1024)              # the cell holding each value
    for ch, d in ((13, 10), (14, 10), (15, 4), (16, 4)):
        assert torch.equal(_bits(cells[first, ch]), rounded(d)), ch
    # The six own stats: 256 boards x 4 agents hold 0-1023 each (a window
    # of range 0, off the board for most of them).
    s = v.reshape(256, 4)
    g = empty_cell_state(256, "cpu")._replace(
        agent_x=s, agent_y=s, agent_max_bombs=s, agent_bomb_count=s,
        agent_strength=s)
    own = launch.ego_features(features_lib, None, g, (0, 1, 2, 3), 0)
    own = own.reshape(1024, 23)
    for ch, d in ((17, 5), (18, 5), (19, 10), (21, 10), (22, 10)):
        assert torch.equal(_bits(own[:, ch]), rounded(d)), ch


def test_feature_marshalling_calls_no_operator_but_the_allocation(
        features_lib, feature_states):
    """On the env step's arrays the path dispatches no PyTorch operator
    that could launch work (``chip_smoke.device_ops``; the output's
    ``empty`` is an allocation), with ``out`` or without; it counts its rows
    and, on the host build, no launch."""
    game = feature_states["random"]
    out = torch.empty((37, 2, 1863), dtype=torch.bfloat16)
    _ext.reset_launches()
    before = trace.COUNTERS["feature_rows"]
    assert chip_smoke.device_ops(lambda: launch.ego_features(
        features_lib, None, game, (0, 3), 4, out=out)) == []
    assert chip_smoke.device_ops(lambda: launch.ego_features(
        features_lib, None, game, (1,), 4)) == []
    assert trace.COUNTERS["feature_rows"] - before == 37 * 3
    assert not any(_ext.LAUNCHES.values())


def test_feature_path_refuses_what_it_does_not_take(features_lib,
                                                    feature_states):
    game = feature_states["reset"]
    run = functools.partial(launch.ego_features, features_lib, None)
    for bad, match in [
            (game._replace(board=game.board.long()), "board must be"),
            (game._replace(agent_can_kick=game.agent_can_kick.int()),
             "agent_can_kick must be"),
            (game._replace(agent_x=game.agent_x.t().contiguous().t()),
             "agent_x must be"),
            (game._replace(bomb_dir=game.bomb_dir[:, :120]), "bomb_dir must")]:
        with pytest.raises(ValueError, match=match):
            run(bad, (0,), 4)
    traj = torch.empty((37, 2, 1863), dtype=torch.bfloat16)
    for out in (traj[:, :1], traj.float(), traj[:36]):
        with pytest.raises(ValueError, match="out must be"):
            run(game, (0,), 4, out=out)
    for slots in ((), (4,), (0, -1), (0,) * 17):
        with pytest.raises(ValueError, match="slots must name"):
            run(game, slots, 4)
    with pytest.raises(ValueError, match="view_range"):
        run(game, (0,), 65)


@pytest.mark.parametrize("case", ["vs_simple", "selfplay", "frozen"])
def test_collect_through_the_feature_source_matches_plain(
        features_lib, monkeypatch, case):
    """``collect_rollout_batch`` with the kernel's source in the features'
    place writes every trajectory row in place and returns what the plain
    path returns, bit for bit, with both generators in the same state
    after; every act of it took the kernel (``feature_rows`` equals
    ``model_rows``), the bootstrap's and the frozen net's included."""
    cfgs = {
        "vs_simple": tppo.PPOConfig(rollout_len=5, opponent="simple",
                                    learner_slots=(0,), fused_env=True),
        "selfplay": tppo.PPOConfig(rollout_len=5, fused_env=True),
        "frozen": tppo.PPOConfig(rollout_len=5, opponent="frozen+simple",
                                 learner_slots=(0, 2), frozen_slots=(1,),
                                 fused_env=True),
    }
    cfg = cfgs[case]
    b = 9

    def collect(kernel):
        libs = {"features": features_lib} if kernel else {}
        monkeypatch.setattr(launch, "card", host_card(libs))
        ts = tppo.ppo_init(3, cfg, device="cpu")
        frozen = tppo.ppo_init(4, cfg, device="cpu").model
        es = env.env_reset(6, b, device="cpu")
        before = dict(trace.COUNTERS)
        out = tppo.collect_rollout_batch(
            ts.model, es, cfg, ts.gen, frozen_model=frozen,
            host_gen=ts.host_gen, device="cpu")
        counts = {k: trace.COUNTERS[k] - before[k]
                  for k in ("feature_rows", "model_rows")}
        return out, counts, ts.gen.get_state(), ts.host_gen.get_state()

    (k_out, k_counts, k_gen, k_host) = collect(True)
    (p_out, p_counts, p_gen, p_host) = collect(False)
    assert k_counts["feature_rows"] == k_counts["model_rows"] > 0
    assert p_counts["feature_rows"] == 0
    assert torch.equal(k_gen, p_gen) and torch.equal(k_host, p_host)
    (k_es, k_traj, k_boot), (p_es, p_traj, p_boot) = k_out[:3], p_out[:3]
    for f, kt, pt in zip(tppo.Transition._fields, k_traj, p_traj):
        assert torch.equal(kt.view(torch.uint8), pt.view(torch.uint8)), f
    assert torch.equal(k_boot, p_boot)
    assert not diff_fields(k_es.game, p_es.game, skip=())
    assert all(torch.equal(a, c) for a, c in zip(k_es[1:], p_es[1:]))
