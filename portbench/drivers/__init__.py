"""The general drivers: each runs every traffic mix that names it, with the
mix's parameters.  A driver module exposes ``Driver(ctx)`` with ``setup()``,
``window(rec)`` and ``check(rec)``, and ``control(ctx)``, the program that
the control run puts in the port's place."""
