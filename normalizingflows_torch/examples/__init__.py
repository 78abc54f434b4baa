"""The demos and the parity harness of the port.

Counterparts of the repository's `examples/demo_*.py` and
`benchmarks/parity.py`, each runnable as a module, on the card unless
``--device cpu`` is given, e.g.
``python -m normalizingflows_torch.examples.demo_neural_spline_flow
--iters 400`` or ``python -m normalizingflows_torch.examples.parity
--workload all --out build/parity_torch.json``.
"""
