"""The work a cell's algorithm needs, counted from its shapes: the
conditioners' matmul FLOPs, and the operations and bytes of the RQS
kernels K1/K2 and the coupling kernels K4/K5. The counts follow the
algorithm as the plain reference states it, not what a kernel happens to
do, so they read the same whatever implements them."""

from __future__ import annotations

from . import peaks
from .reference import nsf as ref_nsf
from .reference import realnvp as ref_realnvp


def conditioners(cfg: dict) -> list[list[int]]:
    """The widths of every Dense chain of the flow."""
    fam = cfg["family"]
    n_c = 2 * cfg["nlayers"]
    if fam == "nsf":
        return [ref_nsf.conditioner_widths(cfg, c) for c in range(n_c)]
    if fam == "realnvp":
        return [ref_realnvp.conditioner_widths(cfg, c)
                for c in range(n_c) for _ in ("s", "t")]
    raise ValueError(f"no work count for family {fam!r}")


def forward_flops(cfg: dict, rows: int) -> float:
    """2 * rows * sum(in * out) over every Dense of every coupling."""
    macs = sum(a * b for w in conditioners(cfg) for a, b in zip(w[:-1], w[1:]))
    return 2.0 * rows * macs


def train_flops(cfg: dict, batch: int) -> float:
    """A training step's: forward, and backward at twice the forward
    (the input cotangent and the weight gradient of each product);
    recomputation is not counted."""
    return 3.0 * forward_flops(cfg, batch)


# ---------------------------------------------------------------- RQS K1/K2

def rqs_forward_ops(K: int) -> int:
    """Operations of one element of the forward spline (each add,
    multiply, divide, compare, select, exp, log as one): two softmaxes
    over K (5K - 2 each) and their floors (2K each); two knot tables
    (cumsum and scale, 3(K - 1) each); K - 1 softplus derivatives with
    their floor (7 each); the box test and clamp (5); the bin search
    (K - 1 compares, K - 2 adds); bin width, height, slope and position
    (6); the denominator (6), the value (8), the derivative (12), its log
    (1) and the two selects (2): 29K + 20."""
    return 29 * K + 20


def rqs_backward_ops(K: int) -> int:
    """One element of the spline's VJP: the forward values it needs, then
    the reverse sweep at two operations for each forward one."""
    return 3 * rqs_forward_ops(K)


def rqs_bytes(kernel: str, n: int, K: int, word_bytes: int = 4) -> int:
    """K1 reads x and 3K - 1 raw words and writes y and the log-det: 3K + 2
    words an element. K2 reads x, raw, the cotangents of y and of the
    log-det and writes those of x and raw: 6K + 2."""
    words = 3 * K + 2 if kernel == "K1" else 6 * K + 2
    return n * words * word_bytes


def rqs_bound_s(kernel: str, n: int, K: int, word_bytes: int = 4) -> float:
    ops = rqs_forward_ops(K) if kernel == "K1" else rqs_backward_ops(K)
    return max(rqs_bytes(kernel, n, K, word_bytes) / peaks.BYTES_PER_S,
               n * ops / peaks.F32_PER_S)


def rqs_elements(cfg: dict, rows: int) -> list[int]:
    """Elements each coupling's spline transforms, in order."""
    return [rows * n_t for n_t in ref_nsf.n_transformed(cfg)]


# ------------------------------------------------------------ coupling K4/K5

def coupling_n_params(cfg: dict) -> int:
    return sum(a * b + b for w in conditioners(cfg)
               for a, b in zip(w[:-1], w[1:]))


def coupling_ops(kernel: str, cfg: dict) -> tuple[int, int]:
    """(MAC operations, other operations) one row of K4 or K5 needs. Per
    coupling and net: a multiply and an add per weight (the MACs), a bias
    add and an activation per unit; per transformed element an exp, a
    multiply, an add and the log-det add. K5's work is the VJP's: one
    forward, then per layer the weight gradient and the input cotangent (a
    MAC each per weight and row), the slope and the bias gradient per
    unit, and 6 operations per transformed element."""
    mac_ops = other = 0
    for c, n_a in enumerate(ref_realnvp.n_transformed(cfg)):
        w = ref_realnvp.conditioner_widths(cfg, c)
        macs = sum(a * b for a, b in zip(w[:-1], w[1:]))
        units = sum(w[1:])
        mac_ops += 2 * 2 * macs
        other += 2 * 2 * units + 4 * n_a
        if kernel != "K4":
            mac_ops += 2 * 4 * macs
            other += 2 * 2 * units + 6 * n_a
    return mac_ops, other


def coupling_bytes(kernel: str, cfg: dict, n: int, word_bytes: int = 4):
    """K4 reads x and the weights and writes y and the log-det; K5 reads x,
    the cotangents of y and the log-det and the weights and writes the
    cotangent of x and the weight gradients."""
    d, n_params = cfg["dim"], coupling_n_params(cfg)
    if kernel == "K4":
        words = n * (2 * d + 1) + n_params
    else:
        words = n * (3 * d + 1) + 2 * n_params
    return words * word_bytes


def coupling_bound_s(kernel: str, cfg: dict, n: int, word_bytes: int = 4):
    """float32: every operation at the float32 rate."""
    macs, other = coupling_ops(kernel, cfg)
    return max(coupling_bytes(kernel, cfg, n, word_bytes) / peaks.BYTES_PER_S,
               n * (macs + other) / peaks.F32_PER_S)
