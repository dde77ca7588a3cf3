"""The benchmark of the PyTorch and CUDA port, ``pomcpp_tpu_torch``.

Run one cell of ``BENCHMARK.json`` from the root of a checkout::

    python3 -m portbench --workload ffa.simple_chunk --seed 7 --seconds 10 --trace 0

The harness is driven by data: a cell names a configuration
(``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``); the
mix names the general driver that runs it (``drivers/<driver>.py``) and
its parameters; each metric is read by ``metrics/<name>.py`` (a split
such as ``device_idle_pct.envloop`` by the reader of the part before the
first dot).  ``reference/`` is the plain PyTorch the outputs are judged
against; it imports nothing of the program.
"""
