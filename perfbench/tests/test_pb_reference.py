"""The plain reference against independent float64 evaluations at tiny
sizes: the spline by scalar arithmetic, each flow's log-det by the
log-determinant of its autograd Jacobian, the Banana density by the
Gaussian it is a unit-Jacobian image of, Adam by `torch.optim.Adam`."""

import math

import numpy as np
import pytest
import torch

from perfbench import weights
from perfbench.reference import nsf, precision, realnvp, target_banana, vi

NSF = dict(family="nsf", dim=4, hidden_dims=[8, 8], K=5, B=3.0, nlayers=2,
           target=dict(name="Banana", dim=4, b=1.0, var=100.0),
           optimizer=dict(lr=1e-2, betas=[0.9, 0.999], eps=1e-8))
RNVP = dict(family="realnvp", dim=3, hidden_dims=[8, 8], nlayers=2,
            target=dict(name="Banana", dim=3, b=1.0, var=100.0),
            optimizer=dict(lr=1e-2, betas=[0.9, 0.999], eps=1e-8))


def _weights(cfg, seed=7):
    mod = nsf if cfg["family"] == "nsf" else realnvp
    w = weights.draw(mod.leaves(cfg), weights.generator(seed, "cpu"), "cpu")
    return vi.cast(w, "float64")


def _scalar_spline(x, raw, B):
    """Durkan et al. eqs. 4-5 element by element, in Python floats."""
    K = (len(raw) + 1) // 3

    def softmax(v):
        m = max(v)
        e = [math.exp(a - m) for a in v]
        return [a / sum(e) for a in e]

    w = [1e-3 + (1 - 1e-3 * K) * a for a in softmax(raw[:K])]
    h = [1e-3 + (1 - 1e-3 * K) * a for a in softmax(raw[K:2 * K])]
    d = [1.0] + [1e-3 + math.log1p(math.exp(a)) for a in raw[2 * K:]] + [1.0]
    xs, ys = [-B], [-B]
    for a, b in zip(w, h):
        xs.append(xs[-1] + 2 * B * a)
        ys.append(ys[-1] + 2 * B * b)
    xs[-1], ys[-1] = B, B
    if not -B <= x <= B:
        return x, 0.0
    k = max(i for i in range(K) if xs[i] <= x)
    s = (ys[k + 1] - ys[k]) / (xs[k + 1] - xs[k])
    t = (x - xs[k]) / (xs[k + 1] - xs[k])
    den = s + (d[k + 1] + d[k] - 2 * s) * t * (1 - t)
    y = ys[k] + (ys[k + 1] - ys[k]) * (s * t * t + d[k] * t * (1 - t)) / den
    der = s * s * (d[k + 1] * t * t + 2 * s * t * (1 - t)
                   + d[k] * (1 - t) ** 2) / den ** 2
    return y, math.log(der)


def test_spline_against_scalar_arithmetic():
    g = torch.Generator().manual_seed(3)
    raw = torch.randn((64, 3 * 6 - 1), generator=g, dtype=torch.float64) * 2
    x = torch.cat([torch.linspace(-3.5, 3.5, 62, dtype=torch.float64),
                   torch.tensor([-3.0, 3.0], dtype=torch.float64)])
    y, ld = nsf.spline(x, raw, 3.0)
    for i in range(64):
        ys, lds = _scalar_spline(float(x[i]), raw[i].tolist(), 3.0)
        assert float(y[i]) == pytest.approx(ys, rel=1e-12, abs=1e-12)
        assert float(ld[i]) == pytest.approx(lds, rel=1e-10, abs=1e-12)


@pytest.mark.parametrize("cfg", [NSF, RNVP], ids=["nsf", "realnvp"])
def test_log_det_is_the_jacobians(cfg):
    mod = nsf if cfg["family"] == "nsf" else realnvp
    w = _weights(cfg)
    x = torch.randn((5, cfg["dim"]), generator=torch.Generator().manual_seed(
        1), dtype=torch.float64)
    _, ld = mod.forward_and_log_det(w, x, cfg, "float64")
    for i in range(5):
        jac = torch.autograd.functional.jacobian(
            lambda v: mod.forward_and_log_det(w, v[None], cfg,
                                              "float64")[0][0], x[i])
        assert float(ld[i]) == pytest.approx(
            float(torch.linalg.slogdet(jac)[1]), rel=1e-9, abs=1e-10)


def test_realnvp_coupling_by_hand():
    cfg = dict(RNVP, nlayers=1, dim=2)
    w = _weights(cfg)
    x = torch.tensor([[0.3, -1.2]], dtype=torch.float64)

    def net(prefix, v, tanh):
        h = v
        for li in range(3):
            h = h @ w[f"{prefix}.l{li}.W"] + w[f"{prefix}.l{li}.b"]
            h = torch.where(h >= 0, h, 0.01 * h) if li < 2 else (
                torch.tanh(h) if tanh else h)
        return h

    s0 = net("c0.s", x[:, 1:], True)
    a = x[:, :1] * torch.exp(s0) + net("c0.t", x[:, 1:], False)
    s1 = net("c1.s", a, True)
    b = x[:, 1:] * torch.exp(s1) + net("c1.t", a, False)
    y, ld = realnvp.forward_and_log_det(w, x, cfg, "float64")
    assert torch.allclose(y, torch.cat([a, b], -1), rtol=0, atol=1e-15)
    assert torch.allclose(ld, (s0 + s1)[:, 0], rtol=0, atol=1e-15)


def test_banana_is_a_gaussian_pushed_through_phi():
    rng = np.random.default_rng(0)
    y = rng.normal(size=(7, 4)) * 3
    var, b = 100.0, 1.0
    z = y.copy()
    z[:, 1] = y[:, 1] + b * y[:, 0] ** 2 - var * b
    sd = np.array([math.sqrt(var), 1, 1, 1])
    want = (-0.5 * ((z / sd) ** 2).sum(1) - np.log(sd).sum()
            - 2 * math.log(2 * math.pi))
    got = target_banana.log_prob(torch.from_numpy(y), 4, b, var)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13)


def test_adam_is_torchs():
    cfg = NSF
    w = _weights(cfg)
    draws = [torch.randn((16, 4), generator=torch.Generator().manual_seed(s),
                         dtype=torch.float64) for s in range(3)]
    ref = vi.train(w, draws, cfg, "float64")
    _, g1, _, _, _ = vi.adam_step(
        w, {k: torch.zeros_like(v) for k, v in w.items()},
        {k: torch.zeros_like(v) for k, v in w.items()}, 1, draws[0], cfg,
        "float64")
    p = {k: v.clone().requires_grad_() for k, v in w.items()}
    opt = torch.optim.Adam(p.values(), lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
    for t, x in enumerate(draws):
        opt.zero_grad()
        loss = -vi.elbo(p, x, cfg, "float64")
        loss.backward()
        assert float(loss.detach()) == pytest.approx(ref["losses"][t],
                                                     rel=1e-13)
        if t == 0:
            for k in p:
                torch.testing.assert_close(p[k].grad, g1[k], rtol=1e-13,
                                           atol=0)
        opt.step()
        for k in p:
            torch.testing.assert_close(p[k].detach(), ref["p"][t + 1][k],
                                       rtol=1e-12, atol=1e-15)
            torch.testing.assert_close(opt.state[p[k]]["exp_avg"],
                                       ref["m"][t + 1][k], rtol=1e-10,
                                       atol=1e-15)


def test_tf32_rounding():
    one = 1.0
    ulp = 2.0 ** -10
    vals = torch.tensor([one + ulp / 2, one + 3 * ulp / 2, one + ulp / 4,
                         -(one + 3 * ulp / 4), 3.0e-3], dtype=torch.float32)
    got = precision.round_tf32(vals).tolist()
    assert got[0] == one                      # a tie goes to even
    assert got[1] == one + 2 * ulp            # a tie goes to even
    assert got[2] == one
    assert got[3] == -(one + ulp)
    m, e = math.frexp(3.0e-3)
    assert got[4] == pytest.approx(math.ldexp(round(m * 2 ** 11) / 2 ** 11,
                                              e), rel=0)


def test_tf32_control_differs_from_float32():
    cfg = NSF
    w = _weights(cfg)
    x = torch.randn((32, 4), generator=torch.Generator().manual_seed(2))
    y32, _ = vi.sample_and_log_prob(vi.cast(w, "float32"), x, cfg, "float32")
    ytf, _ = vi.sample_and_log_prob(vi.cast(w, "tf32"), x, cfg, "tf32")
    y64, _ = vi.sample_and_log_prob(w, x.double(), cfg, "float64")
    assert (ytf.double() - y64).abs().max() > 30 * (y32.double()
                                                    - y64).abs().max()


def test_branches_are_recorded_and_taken_in_call_order():
    from perfbench.reference import nets

    h32 = torch.tensor([1e-9, -1e-9, 2.0, -2.0])
    with nets.branches() as taken:
        nets.leaky_relu(h32)
        nets.leaky_relu(-h32)
    assert [t.tolist() for t in taken] == [[True, False, True, False],
                                           [False, True, False, True]]
    h64 = torch.tensor([-1e-12, 1e-12, 2.0, -2.0], dtype=torch.float64)
    with nets.branches(taken):
        a = nets.leaky_relu(h64)
        b = nets.leaky_relu(-h64)
    assert a.tolist() == [-1e-12, 0.01e-12, 2.0, -0.02]
    assert b.tolist() == [0.01e-12, -1e-12, -0.02, 2.0]
    assert nets.leaky_relu(h64).tolist() == [-0.01e-12, 1e-12, 2.0, -0.02]
