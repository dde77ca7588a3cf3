"""The port's probes vs the Pallas bodies of ``scripts/microbench_*.py``.

Each script is loaded by path; its kernel body is wrapped in a
``pl.pallas_call(..., interpret=True)`` over two 128-row blocks with a small
loop count (the scripts read ``K`` as a module global at trace time).  The
same seeded inputs go through the port's entry point on the CPU (the plain
version).  Tolerance: exact equality (integers; the f32 products are exact
on these inputs: a shift matrix over small integers, 16-bit halves summed
over 128 lanes).
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pomcpp_tpu.utils import device_lock
from pomcpp_tpu_torch import probes

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
N_ROWS, K = 256, 3


@functools.lru_cache(maxsize=None)
def _script(name):
    """The script as a module.  Importing one pins the TPU client lock (a
    no-op on a CPU-pinned process, stubbed here all the same) and points
    JAX's compilation cache at a directory; both are undone."""
    cache = jax.config.jax_compilation_cache_dir
    hold, device_lock.hold_tpu_client_lock = \
        device_lock.hold_tpu_client_lock, lambda *a, **k: None
    try:
        spec = importlib.util.spec_from_file_location(
            f"_probe_script_{name}", SCRIPTS / f"microbench_{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        device_lock.hold_tpu_client_lock = hold
        jax.config.update("jax_compilation_cache_dir", cache)
    mod.K = K
    return mod


def _pallas(body, ins, out_like):
    """``body`` over 128-row blocks of the inputs, in interpret mode; a
    [128, 128] input is the matrix every block sees."""
    def spec(a):
        if a.shape[0] == 128 and len(ins) > 1 and a is ins[-1] \
                and a.dtype == np.float32:
            return pl.BlockSpec(a.shape, lambda i: (0, 0))
        return pl.BlockSpec((128, a.shape[1]), lambda i: (i, 0))

    single = not isinstance(out_like, (list, tuple))
    outs = [out_like] if single else list(out_like)
    res = pl.pallas_call(
        body, grid=(N_ROWS // 128,),
        in_specs=[spec(a) for a in ins],
        out_specs=[pl.BlockSpec((128, o.shape[1]), lambda i: (i, 0))
                   for o in outs],
        out_shape=[jax.ShapeDtypeStruct(o.shape, o.dtype) for o in outs],
        interpret=True,
    )(*map(jnp.asarray, ins))
    res = [np.asarray(r) for r in res]
    return res[0] if single else res


def _np(t):
    return None if t is None else t.numpy()


def _body(p):
    """The script's Pallas body of pattern ``p`` (rows=128 for sublane)."""
    mod = _script(p.script)
    if p.script == "sublane":
        return getattr(mod, f"_kernel_{p.name}")
    if p.script == "layout":
        return functools.partial(mod._kernel, lanes=p.width)
    return mod.make_kernel(p.name)


def _reference(p, inputs, rows=128):
    body = _body(p)
    if p.script == "sublane":
        body = functools.partial(body, rows=rows)
    if p.family == "elem" and p.script in ("patterns", "reductions"):
        # These bodies carry the agent array through untouched.
        x, agents = _np(inputs["x"]), np.full((N_ROWS, 4), 2, np.int32)
        plane, agents_out = _pallas(body, [x, agents], [x, agents])
        assert np.array_equal(agents_out, agents)
        return plane
    if p.family in ("elem", "dot") or inputs.get("agents") is None:
        x = _np(inputs.get("x", inputs.get("plane")))
        ins = [x] + ([_np(inputs["w"])] if p.family == "dot" else [])
        return _pallas(body, ins, x)
    plane, agents = _np(inputs["plane"]), _np(inputs["agents"])
    return _pallas(body, [plane, agents], [plane, agents])


def _same(ref, got, what):
    if isinstance(ref, list):
        assert isinstance(got, tuple) and len(got) == 2, what
        for name, r, g in zip(("plane", "agents"), ref, got):
            _same(r, g, f"{what} {name}")
        return
    got = got.numpy()
    assert ref.shape == got.shape and ref.dtype == got.dtype, what
    assert np.array_equal(ref, got), \
        f"{what}: {int((ref != got).sum())} of {ref.size} values differ"


@pytest.mark.parametrize("p", probes.PATTERNS, ids=probes.label)
def test_plain_version_matches_pallas_body(p):
    inputs = probes.pattern_inputs(p, N_ROWS, "cpu", seed=len(probes.label(p)))
    got = probes.run_pattern(p, inputs, k=K)
    _same(_reference(p, inputs), got, probes.label(p))
    changed = got[0] if isinstance(got, tuple) else got
    first = inputs.get("x", inputs.get("plane"))
    if p.name not in ("cond_false", "any4", "axis1_any", "rot4_all",
                      "colslice", "whole4", "onehot_rd", "packed_sum",
                      "min_red4"):
        assert not torch.equal(changed, first)      # the probe did something
    elif p.name != "cond_false":
        assert torch.equal(changed, first) and \
            not torch.equal(got[1], inputs["agents"])


@pytest.mark.parametrize("name", ["elem", "roll", "sumred", "dot", "dotred"])
def test_sublane_rows_restrict_the_work(name):
    """``rows=32``: the first 32 rows of every 128 are processed, the rest
    copied -- the sublane script's sweep axis."""
    p = next(q for q in probes.PATTERNS
             if q.script == "sublane" and q.name == name)
    inputs = probes.pattern_inputs(p, N_ROWS, "cpu", seed=7)
    got = probes.run_pattern(p, inputs, k=K, rows=32)
    _same(_reference(p, inputs, rows=32), got, name)
    first = inputs.get("x", inputs.get("plane"))
    assert torch.equal(got.view(2, 128, 128)[:, 32:],
                       first.view(2, 128, 128)[:, 32:])


def test_tile_reductions_see_their_own_tile_only():
    """``any_plane``: a hit in tile 0 must not leak into tile 1."""
    plane = torch.zeros((256, 128), dtype=torch.int32)
    plane[5, 17] = 7
    agents = torch.zeros((256, 4), dtype=torch.int32)
    p, a = probes.probe_reduce(plane, agents, "any_plane", 1, device="cpu")
    assert (p[:128] == plane[:128] + 1).all() and (p[128:] == 2).all()
    assert torch.equal(a, agents)
    with pytest.raises(ValueError, match="tiles"):
        probes.probe_reduce(plane, agents, "any_plane", 1, rows=8, device="cpu")
    with pytest.raises(ValueError, match="agent"):
        probes.probe_reduce(plane, None, "axis1_any", 1, device="cpu")
    with pytest.raises(ValueError, match="agent"):
        probes.probe_shift(plane, None, "whole4", 1, device="cpu")


def test_entry_points_reject_unknown_ops_and_need_a_card_by_default():
    x = torch.ones((128, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown op"):
        probes.probe_elem(x, "nope", 1, device="cpu")
    with pytest.raises(ValueError, match="unknown op"):
        probes.probe_dot(x, x, "nope", 1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            probes.probe_elem(x, "elem", 1)
        with pytest.raises(RuntimeError, match="CUDA"):
            probes.main(["i16"])
    assert probes.main(["nope"]) == 2
    assert len({probes.label(p) for p in probes.PATTERNS}) == len(probes.PATTERNS)
    assert {p.family for p in probes.PATTERNS} == set(probes.FAMILY_KERNEL)


@pytest.mark.parametrize("p", [q for q in probes.PATTERNS if q.closed],
                         ids=probes.label)
@pytest.mark.parametrize("k", [1, 3, 300])
def test_closed_forms_are_the_patterns(p, k):
    """The loops counted as closed forms (``Pattern.closed``) compute their
    closed form: the i8 chain is x & 0x7F, cond_false x, cond_true x + K,
    while_2it x + 2K."""
    x = probes.pattern_inputs(p, 256, "cpu", seed=k)["x"]
    assert torch.equal(probes.CLOSED_FORMS[p.op](x, k),
                       probes.probe_elem_plain(x, p.op, k))
