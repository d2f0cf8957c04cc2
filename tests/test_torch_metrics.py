"""The port's evaluation modules against the JAX package's, on the CPU, and
a short run of ``gecco_tpu_torch.validate``.

``distance_matrix``, the Chamfer distances and ``batched_pairwise_distance``
are held against ``gecco_tpu``'s on the same numpy clouds in fp32 (rtol
1e-5); the scores (1-NN accuracy with the reference's ``<= n``, MMD, COV)
are computed by each package from its own distance matrices and must agree:
1-NN and COV exactly (the same nearest-neighbour indices), MMD to 1e-5.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gecco_tpu import benchmark as jbench
from gecco_tpu import geometry as jgeo
from gecco_tpu import metrics as jmetrics
from gecco_tpu_torch import benchmark as tbench
from gecco_tpu_torch import geometry as tgeo
from gecco_tpu_torch import metrics as tmetrics
from gecco_tpu_torch import validate

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _clouds(seed, n_sets, n_points):
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.5, 1.5, (n_sets, 1, 3))
    return (rng.standard_normal((n_sets, n_points, 3)) * scale).astype(np.float32)


@pytest.mark.parametrize("squared", [False, True], ids=["distance", "squared"])
def test_distance_matrix_matches_jax(squared):
    a, b = _clouds(0, 3, 50), _clouds(1, 3, 40)
    got = tgeo.distance_matrix(torch.from_numpy(a), torch.from_numpy(b), squared=squared)
    want = jgeo.distance_matrix(jnp.asarray(a), jnp.asarray(b), squared=squared)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    # clamped at 0: a set against itself has no negative squared distances
    self_d = tgeo.distance_matrix(torch.from_numpy(a), torch.from_numpy(a), squared=True)
    assert float(self_d.min()) >= 0.0


@pytest.mark.parametrize("fn", ["chamfer_distance", "chamfer_distance_squared"])
def test_chamfer_matches_jax(fn):
    a, b = _clouds(2, 4, 64), _clouds(3, 4, 48)
    got = getattr(tmetrics, fn)(torch.from_numpy(a), torch.from_numpy(b))
    want = getattr(jmetrics, fn)(jnp.asarray(a), jnp.asarray(b))
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


@pytest.mark.parametrize("block_size", [None, 3], ids=["auto", "block3"])
def test_batched_pairwise_distance_matches_jax(block_size):
    a, b = _clouds(4, 7, 32), _clouds(5, 5, 32)
    got = tbench.batched_pairwise_distance(torch.from_numpy(a), torch.from_numpy(b),
                                           tmetrics.chamfer_distance, block_size)
    want = jbench.batched_pairwise_distance(a, b, jmetrics.chamfer_distance, block_size or 16)
    assert got.shape == (7, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("seed", [6, 7])
def test_scores_match_jax(seed):
    samples, data = _clouds(seed, 12, 32), _clouds(seed + 10, 12, 32)
    t = [tbench.batched_pairwise_distance(torch.from_numpy(p), torch.from_numpy(q),
                                          tmetrics.chamfer_distance)
         for p, q in ((samples, samples), (samples, data), (data, data))]
    j = [jbench.batched_pairwise_distance(p, q, jmetrics.chamfer_distance)
         for p, q in ((samples, samples), (samples, data), (data, data))]
    assert np.array_equal(t[1].argmin(dim=1).numpy(), j[1].argmin(axis=1))
    assert tbench.one_nn_accuracy(*t) == jbench.one_nn_accuracy(*j)
    assert tbench.cov(t[1]) == jbench.cov(j[1])
    np.testing.assert_allclose(tbench.mmd(t[1]), jbench.mmd(j[1]), rtol=RTOL)


def test_one_nn_keeps_the_reference_off_by_one():
    """A sample whose nearest neighbour is data cloud 0 (index n of the
    joint matrix) counts as a same-set hit, as in the reference."""
    d_ss = torch.tensor([[0.0, 5.0], [5.0, 0.0]])
    d_sd = torch.tensor([[1.0, 9.0], [9.0, 9.0]])
    d_dd = torch.tensor([[0.0, 9.0], [9.0, 0.0]])
    args = [np.asarray(m.numpy()) for m in (d_ss, d_sd, d_dd)]
    assert tbench.one_nn_accuracy(d_ss, d_sd, d_dd) == jbench.one_nn_accuracy(*args)


TINY = ["--device", "cpu", "--steps", "3", "--n-layers", "2", "--feature-dim", "64",
        "--num-inducers", "16", "--num-heads", "4", "--n-points", "64", "--batch", "4",
        "--eval-every", "3", "--eval-clouds", "4", "--sampler-steps", "2", "--log-every", "1"]


def test_validate_trains_and_scores_on_the_cpu(tmp_path):
    """Three steps of the flagship's loop at 2 layers x 64 wide, then one
    eval of 4 clouds with 2 Heun steps: finite losses, scores in range,
    one JSON line per step and eval, appended to ``--out``."""
    out = tmp_path / "v.jsonl"
    lines = []
    records = validate.run(validate.parser().parse_args(TINY + ["--out", str(out)]),
                           emit=lines.append)
    assert [r["step"] for r in records] == [1, 2, 3, 3]
    assert all(np.isfinite(r["loss"]) for r in records)
    last = records[-1]
    assert 0.0 <= last["one_nn"] <= 1.0 and 0.0 <= last["cov"] <= 1.0
    assert np.isfinite(last["mmd"]) and last["mmd"] >= 0.0
    assert [json.loads(x) for x in out.read_text().splitlines()] == records
    assert [json.loads(x) for x in lines] == records


def test_validate_stops_at_a_non_finite_loss(tmp_path, monkeypatch):
    """The first non-finite loss ends the run with exit code 1 and a record
    that names its step."""

    def nan_step(optimizer, ema_alpha):
        return lambda model, ema, opt_state, points, gen: (torch.tensor(float("nan")), opt_state)

    monkeypatch.setattr(validate, "make_train_step", nan_step)
    out = tmp_path / "v.jsonl"
    assert validate.main(TINY + ["--out", str(out)]) == 1
    rec = json.loads(out.read_text().splitlines()[-1])
    assert rec["step"] == 1 and rec["error"] == "non-finite loss"


def _gate_run(one_nn, loss=0.5):
    """One run's records: a loss line per 1000 steps and an eval per 1000."""
    recs = []
    for k, score in enumerate(one_nn, start=1):
        recs.append(dict(step=1000 * k, loss=loss, loss_mean=loss, wall_s=1.0))
        recs.append(dict(step=1000 * k, loss=loss, wall_s=1.0, one_nn=score, mmd=0.03, cov=0.3))
    return recs


@pytest.mark.parametrize("case,passes", [
    ("within", True),       # each side's mean within the band from step 2000
    ("step1000", True),     # step 1000 is not checked
    ("mean_out", False),    # one eval's means 0.07 apart
    ("nonfinite", False),   # a run logged a non-finite loss
    ("missing", False),     # a run lacks an eval the others have
])
def test_gate_verdict_compares_the_means_of_each_sides_runs(case, passes, tmp_path):
    control = [_gate_run([1.0, 0.99, 0.95, 0.79]), _gate_run([1.0, 0.99, 0.96, 0.81])]
    change = [_gate_run([1.0, 1.0, 0.97, 0.87]), _gate_run([1.0, 1.0, 0.96, 0.79])]
    if case == "step1000":
        change[0][1]["one_nn"] = 0.5
    elif case == "mean_out":
        change[1][7]["one_nn"] = 0.87  # change 0.87 against control 0.80
    elif case == "nonfinite":
        change[1].append(dict(step=4001, loss=float("nan"), error="non-finite loss"))
    elif case == "missing":
        del change[1][5]
    rows, ok = validate.verdict(control, change)
    assert ok is passes
    if case == "within":
        assert [r["step"] for r in rows] == [2000, 3000, 4000]
        last = rows[-1]
        assert last["control"] == pytest.approx(0.80) and last["change"] == pytest.approx(0.83)
        assert last["control_spread"] == pytest.approx(0.02)
        assert last["change_spread"] == pytest.approx(0.08)
    # the command line reads the runs' JSON-lines files and exits 1 on a failed gate
    paths = []
    for q, run in enumerate(control + change):
        path = tmp_path / f"run{q}.jsonl"
        path.write_text("".join(json.dumps(r) + "\n" for r in run))
        paths.append(str(path))
    assert validate.main(["--control", *paths[:2], "--change", *paths[2:]]) == (0 if passes else 1)
