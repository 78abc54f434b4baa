"""chip_smoke.py's on-chip gates, on the CPU: phase 47's witness gate on
the bf16 policy's K4/K5 (`witness_gate`, `witness_errors`) and phase 52's
on float32 K6 (`k6_witness_gate`, `k6_witness_reading`). Each passes an
error at the level of the correct computations it is measured against,
fails one 700 times larger, and catches each faulty control: the plain
versions on a faulty product (phase 47's `WITNESS_CONTROLS`; phase 52's
`_k6_bf16_products`, the conditioners' products on bfloat16 operands).
The plain versions stand in for the kernels here; the kernels themselves
meet the gates on the card (phases 47 and 52, and
benchmarks/torch_leaf_scan.py's scans).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import normalizingflows_torch as nft
from normalizingflows_torch.experimental import coupling_cuda as cc

BF = torch.bfloat16


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def _policy_case(n, seed=0):
    """The demo's fused stack under the policy, perturbed off the identity,
    and draws of x and the cotangents over n rows (numpy, a seed)."""
    g = torch.Generator().manual_seed(30)
    flow = nft.realnvp(g, 2, (16, 16), nlayers=3, fused=True,
                       compute_dtype=BF, device="cpu")
    fb = flow.bijector.bijectors[0]
    with torch.no_grad():
        for p in fb.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    sels = cc._sels(fb.idx_even, fb.idx_odd, 2)
    rng = np.random.default_rng(seed)
    x, gy = (torch.from_numpy(rng.standard_normal((n, 2)).astype(np.float32))
             for _ in range(2))
    gld = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    return fb, sels, x, gy / n, gld / n


@pytest.mark.parametrize("err_w", [1e-7, 3e-5])
def test_witness_gate_passes_witness_level_and_fails_700_times(err_w):
    assert cs.witness_gate(err_w, err_w)
    assert cs.witness_gate(cs.DEEP_WITNESS_FACTOR * err_w, err_w)
    assert not cs.witness_gate(700 * err_w + cs.LEAF_FLOOR, err_w)
    # a witness that agrees with the plain version exactly leaves the floor
    assert cs.witness_gate(cs.LEAF_FLOOR, 0.0)
    assert not cs.witness_gate(2 * cs.LEAF_FLOOR, 0.0)


@pytest.mark.parametrize("inverse", [False, True])
def test_witness_errors_pass_the_witness_and_catch_each_control(inverse):
    """Outputs at the witness's own level (the witness itself as the
    kernel) pass every output's gate; each of WITNESS_CONTROLS fails it in
    some output; and the witness moved 700 times its distance fails."""
    fb, sels, x, gy, gld = _policy_case(512)
    args = (fb, x, gy, gld, sels, inverse)
    plain = cs._plain_on(cc, None, *args, BF)
    witness = cs._plain_on(cc, cs._dot_witness, *args, BF)
    mine, controls = cs.witness_errors(cc, fb, x, gy, gld, sels, inverse, BF,
                                       witness)
    assert len(mine) == 3 + 8 * 3
    assert all(cs.witness_gate(e, ew) for _, e, ew in mine)
    assert set(controls) == set(cs.WITNESS_CONTROLS)
    for label, errs in controls.items():
        assert not all(cs.witness_gate(e, ew) for e, ew in errs), label
    far = [p + 700 * (w - p) for p, w in zip(plain, witness)]
    mine, _ = cs.witness_errors(cc, fb, x, gy, gld, sels, inverse, BF, far)
    moved = [(e, ew) for _, e, ew in mine if ew > 0]
    assert moved and not any(cs.witness_gate(e, ew) for e, ew in moved)


def test_k6_witness_gate_takes_the_larger_float32_error():
    assert cs.k6_witness_gate(4e-6, 1e-6, 1e-6)
    assert not cs.k6_witness_gate(700e-6, 1e-6, 1e-6)
    assert cs.k6_witness_gate(4e-6, 2e-7, 1e-6)
    assert cs.k6_witness_gate(4e-6, 1e-6, 2e-7)
    assert not cs.k6_witness_gate(cs.K6_WITNESS_FACTOR * 1e-6
                                  + 2 * cs.LEAF_FLOOR, 1e-6, 2e-7)


def test_k6_first_gate_takes_the_larger_float32_error_and_its_floor():
    f = cs.K6_FIRST_FACTOR
    assert cs.k6_first_gate(4e-7, 1e-7, 1e-7)
    assert cs.k6_first_gate(cs.K6_FIRST_FLOOR, 0.0, 0.0)
    assert not cs.k6_first_gate(10 * f * 1e-7, 1e-7, 1e-7)
    assert cs.k6_first_gate(f * 1e-7, 2e-8, 1e-7)
    assert not cs.k6_first_gate(f * 1e-7 + 2 * cs.K6_FIRST_FLOOR, 1e-7,
                                2e-8)


def _k6_args(model, batch, target, seed, steps=25):
    """adam_train_realnvp_fused's float32 arguments on the CPU, as
    `chip_smoke._train_args` makes them on the card (flow seed 52,
    perturbed; the draws from numpy)."""
    cfg = cs.CPL_CFG[model]
    flow = nft.realnvp(torch.Generator().manual_seed(52), fused=True,
                       device="cpu", **cfg)
    with torch.no_grad():
        g = torch.Generator().manual_seed(2)
        for p in flow.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    fb = flow.bijector.bijectors[0]
    rng = np.random.default_rng(seed)
    xs = torch.from_numpy(rng.standard_normal(
        (steps, batch, cfg["q0"])).astype(np.float32))
    xs = (flow.base.loc + flow.base.scale * xs).detach()
    return (xs, fb.groups, fb.idx_even, fb.idx_odd,
            cs._k6_target(target, cfg["q0"]), flow.base.loc.detach(),
            flow.base.scale.detach(), cs.RNVP_LR)


@pytest.mark.parametrize("target", ["banana", "funnel", "warped"])
def test_k6_witness_reading_passes_plain_level_and_catches_the_control(
        target):
    """The float32 plain version read as the kernel passes phase 52's gate
    in every output (the first loss read as one more); the faulty control
    (bfloat16 products) fails it in some output; an error 700 times the
    larger float32 run's fails."""
    from normalizingflows_torch.experimental import train_cuda as tc

    args = _k6_args("demo", 16, target, 0)
    got = cs._train_outputs(tc.adam_train_plain(*args))
    errs, want = cs.k6_witness_reading(got, args)
    assert len(errs) == len(want) + 1 == 2 + 8 * 3
    assert all(cs.k6_witness_gate(e, e32, er) for e, e32, er, _ in errs)
    assert not all(cs.k6_witness_gate(ec, e32, er)
                   for _, e32, er, ec in errs)
    assert not any(cs.k6_witness_gate(700 * max(e32, er) + cs.LEAF_FLOOR,
                                      e32, er) for _, e32, er, _ in errs)
    # the shuffled rows are another correct float32 order: the same ELBO
    assert max(er for _, _, er, _ in errs) < 1e-3


@pytest.mark.parametrize("model,batch", [("demo", 16), ("ref", 64)])
@pytest.mark.parametrize("target", ["banana", "funnel", "warped"])
def test_k6_first_reading_passes_plain_level_and_catches_the_control(
        target, model, batch):
    """Phase 52's check before Adam amplifies roundoff, on the first
    batch drawn off the kinks: the float32 plain version's first loss and
    first moment (`_first_step_plain`, standing in for K6's
    device-resident one) pass `k6_first_gate` in every output; the faulty
    control (bfloat16 products) fails it in some output; an error ten
    times the limit fails. The first moment is (1 − β₁) times the plain
    version's first gradient, the trainer's own first Adam step."""
    from normalizingflows_torch.experimental import train_cuda as tc

    args = cs.k6_first_args(_k6_args(model, batch, target, 0, steps=1))
    got = cs._first_step_plain(args)
    first = cs.k6_first_reading(got, args)
    assert len(first) == 1 + 8 * len(cs.CPL_CFG[model]["hdims"]) + 8
    assert all(cs.k6_first_gate(e, e32, er) for e, e32, er, _ in first)
    assert not all(cs.k6_first_gate(ec, e32, er) for _, e32, er, ec in first)
    assert not any(cs.k6_first_gate(10 * cs.K6_FIRST_FACTOR * max(e32, er)
                                    + 2 * cs.K6_FIRST_FLOOR, e32, er)
                   for _, e32, er, _ in first)
    run, leaves = tc._prepare(*args, 0.9, 0.999, 1e-8)
    _, grads = tc._loss_and_grads(args[0][0], leaves, run)
    for m, g in zip(got[1:], grads):
        assert torch.equal(m, (1.0 - 0.9) * g)


def test_k6_first_args_draw_the_first_batch_off_the_kinks():
    """`k6_first_args` keeps one step and draws again exactly the rows of
    the first batch that `_kink_rows` flags, from the base, until none is
    flagged; the rest of the batch and the other arguments stay."""
    args = _k6_args("demo", 64, "banana", 0, steps=3)
    sels = cc._sels(args[2], args[3], 2)
    real = cs.KINK
    try:  # a wider band, so that some rows of 64 are near a kink
        cs.KINK = 1e-3
        near = cs._kink_rows(cc, args[0][0], args[1], sels)
        got = cs.k6_first_args(args)
        assert not cs._kink_rows(cc, got[0][0], args[1], sels).any()
    finally:
        cs.KINK = real
    assert got[0].shape == (1,) + args[0].shape[1:]
    assert near.any() and not near.all()
    moved = (got[0][0] != args[0][0]).any(1)
    assert torch.equal(moved & ~near, torch.zeros_like(near))
    assert all(a is b for a, b in zip(got[1:], args[1:]))


def test_k6_shuffled_rows_are_the_same_run():
    """`_k6_shuffled` reorders each step's rows by one fixed permutation: in
    float64 the run is the same to roundoff (the ELBO's mean and its
    gradient's sum do not depend on the order)."""
    from normalizingflows_torch.experimental import train_cuda as tc

    args = cs._as_f64(_k6_args("demo", 16, "banana", 1, steps=5))
    shuffled = cs._k6_shuffled(args)[0]
    assert not torch.equal(shuffled, args[0])
    assert torch.equal(shuffled.sort(dim=1).values, args[0].sort(dim=1).values)
    a = cs._train_outputs(tc.adam_train_plain(*args))
    b = cs._train_outputs(tc.adam_train_plain(*cs._k6_shuffled(args)))
    for x, y in zip(a, b):
        assert cs._rel([x], [y]) < 1e-12
