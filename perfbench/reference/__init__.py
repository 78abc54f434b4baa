"""Plain PyTorch references of the benchmark's configurations.

Nothing here imports the program under test (`normalizingflows_torch`),
the JAX package or JAX: every module is written from the published
algorithms and takes only the benchmark's own inputs (the weights and the
base draws it made from the seed). A configuration's ``family`` names its
module here (`nsf`, `realnvp`), its target's ``name`` a module
``target_<name>``.
"""
