"""``phase_pct.<phase>``: 100 x the phase's warp cycles over all phase
cycles, summed over the window's sampled chunk calls (the chunk kernel's
clocked instance, one call in 8 while the program traces)."""

from ..program_trace import rows


def read(rec, name):
    got = rows(rec)
    if not got:
        return None
    phase = name.split(".", 1)[1]
    cycles = [k for k in got[0] if not k.startswith("n_")]
    total = sum(r[k] for r in got for k in cycles)
    if total <= 0:
        return None
    return 100.0 * sum(r[phase] for r in got) / total
