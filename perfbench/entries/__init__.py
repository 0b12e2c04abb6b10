"""The ways users call the port, as the benchmark drives them.  One module
here a kind of entry, named by the ``entry`` key of a traffic file and
found by that name: a later entry kind is a file of its own.

Each module exports ``Entry`` and ``Control``.  ``Entry(config, traffic,
seed, device, program=None)`` makes its pool of inputs on the device from
the seed (the benchmark's own encoder and AWGN channel), issues one call at a
time (``call``), says what a call released (``bits``) and what is kept of it
for the comparison (``keep``), gives the least time of a call's kernels
(``bounds``), and once the window has closed compares what it kept with the
plain reference (``check``).  The program receives only the symbols.
``program`` replaces the port with another implementation of the same
calls; ``Control`` is the plain reference put there with the select rule
reversed, and ``Control.CALLS_PER_POOL`` the calls a control run makes per
pool entry."""

from __future__ import annotations

import importlib
import re

__all__ = ["load"]


def load(kind: str):
    """The module of the entry kind ``kind``."""
    if not re.fullmatch(r"[a-z][a-z0-9_]*", kind) or kind == "common":
        raise SystemExit(f"no entry kind {kind!r}")
    return importlib.import_module(f"{__name__}.{kind}")
