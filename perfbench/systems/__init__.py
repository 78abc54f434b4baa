"""The program under test, `normalizingflows_torch`, as each family's
cells build it. A configuration's ``family`` names its module here: it
builds the port's flow through its public constructor, copies the
benchmark's canonical weights in, and reads any per-parameter tensor of
the program (its weights, Adam's moments) back in the canonical layout.
"""

import importlib


def program():
    """The port, imported at run time (a test may replace parts of it
    first)."""
    return importlib.import_module("normalizingflows_torch")


def family(cfg: dict):
    return importlib.import_module(f"{__package__}.{cfg['family']}")


def target(cfg: dict):
    """The port's target of the configuration."""
    tgt = dict(cfg["target"])
    return getattr(program(), tgt.pop("name"))(**tgt)
