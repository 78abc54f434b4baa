"""A whole run of each cell on the CPU at a tiny size, with the harness's
look for a card skipped: sound, it comes out correct; with the timed path
broken underneath, or with the control (the reference in TF32) in the
program's place, it does not. The cells' own limits are used."""

import time

import pytest
import torch

from perfbench import calibrate, harness, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
TRAIN = [c for c in CELLS if spec.cell(c).traffic["kind"] == "train_elbo"]
SAMPLE = [c for c in CELLS if spec.cell(c).traffic["kind"] == "sample"]


def tiny(name: str) -> spec.Cell:
    """The cell cut to what a test run holds: the neural spline flow's
    widths, depth and batch, and every cell's chunk. RealNVP's reference
    default is small, and keeps its widths, depth and batch."""
    cell = spec.cell(name)
    cfg, traffic = dict(cell.config), dict(cell.traffic)
    if cfg["family"] == "nsf":
        cfg.update(hidden_dims=[16, 16], nlayers=3, dim=8, K=6)
        cfg["target"] = dict(cfg["target"], dim=cfg["dim"])
        traffic["batch"] = 64
    elif traffic["kind"] == "sample":
        traffic["batch"] = 4096
    if "check_every" in traffic:
        traffic["check_every"] = 20
    cell.config, cell.traffic = cfg, traffic
    return cell


def run(name, seed=3_000_000_019, seconds=0.2, trace=False):
    r = harness.Run(tiny(name), seed, seconds, trace, torch.device("cpu"),
                    time.perf_counter(), log=lambda *a: None)
    return harness.run_cell(r)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    result, rows = run(name)
    assert result["correct"], rows
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {m["name"]
                                      for m in spec.cell(name).end_to_end}


def test_a_traced_run_reports_per_layer_metrics_only():
    result, _ = run(TRAIN[0], trace=True)
    names = {m["name"] for m in spec.cell(TRAIN[0]).per_layer}
    assert set(result["metrics"]) <= names
    assert "window_s" in result["device"] and "breakdown" in result


@pytest.fixture
def nft():
    import normalizingflows_torch

    return normalizingflows_torch


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_that_leaves_the_weights_unchanged_fails(name, monkeypatch):
    step = torch.optim.Adam.step

    def unchanged(self, *a, **k):
        before = [p.detach().clone() for g in self.param_groups
                  for p in g["params"]]
        out = step(self, *a, **k)
        with torch.no_grad():
            for p, b in zip((p for g in self.param_groups
                             for p in g["params"]), before):
                p.copy_(b)
        return out

    monkeypatch.setattr(torch.optim.Adam, "step", unchanged)
    result, rows = run(name)
    assert not result["correct"], rows


@pytest.mark.parametrize("name", TRAIN)
def test_half_of_the_batch_left_out_fails(name, monkeypatch, nft):
    monkeypatch.setattr(nft.objectives, "elbo_from_samples",
                        calibrate.half_batch(nft))
    result, rows = run(name)
    assert not result["correct"], rows


@pytest.mark.parametrize("name", TRAIN)
def test_every_step_reading_the_first_row_fails(name, monkeypatch, nft):
    """The chunk's buffer read at row 0 by every step, as a replay whose
    index never advanced would read it."""
    orig = nft.train._Steps._fetch

    def first_row(self, chunk, inputs):
        orig(self, chunk, inputs)
        return lambda: self.inputs[0]

    monkeypatch.setattr(nft.train._Steps, "_fetch", first_row)
    result, rows = run(name)
    assert not result["correct"], rows


@pytest.mark.parametrize("name", TRAIN)
def test_a_feed_that_repeats_its_first_row_fails(name, monkeypatch, nft):
    orig = nft.objectives.presample_base

    def repeated(n):
        feed = orig(n)

        def gen(g, fl, chunk):
            return feed(g, fl, chunk)[:1].expand(chunk, -1, -1).contiguous()

        return gen

    monkeypatch.setattr(nft.objectives, "presample_base", repeated)
    result, rows = run(name)
    assert not result["correct"], rows


@pytest.mark.parametrize("name", TRAIN)
def test_later_chunks_on_the_first_chunks_draws_fail(name, monkeypatch,
                                                     nft):
    orig = nft.objectives.presample_base

    def stale(n):
        feed, kept = orig(n), {}

        def gen(g, fl, chunk):
            return kept.setdefault("x", feed(g, fl, chunk))

        return gen

    monkeypatch.setattr(nft.objectives, "presample_base", stale)
    result, rows = run(name)
    assert not result["correct"], rows


def test_the_checked_steps_reach_past_the_warm_steps_and_the_first_chunk():
    from perfbench.drivers import train_elbo

    for seed in (1, 2, 3_000_000_019):
        r = harness.Run(spec.cell(TRAIN[0]), seed, 1.0, False,
                        torch.device("cpu"), 0.0)
        every = r.cell.traffic["check_every"]
        steps = train_elbo.checked_steps(r)
        assert steps[:6] == [1, 2, 3, 4, 5, 6]
        assert every + 1 in steps and max(steps) <= 2 * every
        assert len(steps) in (7, 8)


@pytest.mark.parametrize("name", SAMPLE)
def test_an_answer_altered_where_it_is_produced_fails(name, monkeypatch,
                                                      nft):
    orig = nft.TransformedDistribution.sample_and_log_prob

    def altered(self, *a, **k):
        y, lq = orig(self, *a, **k)
        y = y.clone()
        y[7, 0] += 1e-2 * (1 + y[7, 0].abs())
        return y, lq

    monkeypatch.setattr(nft.TransformedDistribution, "sample_and_log_prob",
                        altered)
    result, rows = run(name)
    assert not result["correct"], rows


@pytest.mark.parametrize("name", SAMPLE)
def test_a_stale_answer_fails(name, monkeypatch, nft):
    orig = nft.TransformedDistribution.sample_and_log_prob
    last = {}

    def stale(self, generator, shape=()):
        out = orig(self, generator, shape)
        return last.setdefault("out", out)

    monkeypatch.setattr(nft.TransformedDistribution, "sample_and_log_prob",
                        stale)
    result, rows = run(name)
    assert not result["correct"], rows


@pytest.mark.parametrize("name", SAMPLE)
def test_draws_never_made_fail(name, monkeypatch, nft):
    """A program that stops drawing (the generator never moves) and hands
    back one answer: every kept call then has the same state."""
    orig = nft.TransformedDistribution.sample_and_log_prob
    last = {}

    def cached(self, generator, shape=()):
        if "out" not in last:
            last["out"] = orig(self, generator, shape)
        return last["out"]

    monkeypatch.setattr(nft.TransformedDistribution, "sample_and_log_prob",
                        cached)
    result, rows = run(name)
    assert not result["correct"], rows


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(name):
    """The reference computed in TF32, put in the program's place."""
    cell = tiny(name)
    r = harness.Run(cell, 3_000_000_021, 0.2, False, torch.device("cpu"),
                    time.perf_counter(), log=lambda *a: None)
    if cell.traffic["kind"] == "train_elbo":
        readings = calibrate.train_readings(r)["control"]
    else:
        readings = calibrate.sample_readings(r)["control"]
    rows = [(k, readings[k], lim) for k, lim in cell.limits.items()]
    assert not all(v <= lim for _, v, lim in rows), rows


@pytest.mark.chip
def test_a_run_on_the_card(card, capsys):
    """One short run of each cell through the harness's entry point."""
    import json

    for name in CELLS:
        rc = harness.main(["--workload", name, "--seed", "3000000023",
                           "--seconds", "1", "--trace", "0"])
        assert rc == 0
        result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert result["correct"] and result["device"]["platform"] == "gpu"
