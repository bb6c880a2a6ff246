"""Seeded fixtures of the port's four device rules (``device-transfer``,
``recompile-hazard``, ``compile-budget``, ``trace-safety``).

Each file marks its true positives with a ``seeded`` comment and keeps
true negatives beside them. The lint's package scan skips this
directory; the tests scan each file by name. The files import only
torch and the port, so they load like any module of the port, but
nothing here is ever called.
"""
