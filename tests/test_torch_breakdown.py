"""The port's breakdown-frontier sweep against the reference's
(``repro.robustness.breakdown``).

A small sweep (n = 6, fs = (1, 2), NNM + CWTM and the undefended average,
sign flip and full-rate label-flip poisoning, 6 rounds: 12 lanes in 4
buckets) runs in both packages from the reference's MLP init (carried
across with ``repro_torch.interop``; ``run_breakdown(params=...)``).
Every cell's window losses agree within the fleet's rtol 1e-4, and the
frontiers are equal, except a cell whose loss lies within that tolerance
of ``collapse_factor`` x its clean loss (none at this size).
``frontier_table`` prints one report identically; ``BreakdownAttack`` and
``fs`` are validated as in the reference; the launcher
(``python -m repro_torch.launch.breakdown``) prints the example's lines.
"""
import jax
import numpy as np
import pytest

from repro.fed.scenarios import _mlp_init as j_mlp_init
from repro.robustness import breakdown as jbd
from repro_torch.fed.poison import PoisonConfig
from repro_torch.interop import mlp_params_from_numpy
from repro_torch.launch import breakdown as launch_breakdown
from repro_torch.robustness import breakdown as tbd
import repro_torch.robustness as trobustness

RTOL = 1e-4
RULES = (("cwtm", "nnm"), ("average", None))
SMALL = dict(n_clients=6, fs=(1, 2), rounds=6, seed=0)


def _attacks(mod, poison_cls):
    return (mod.BreakdownAttack("sf", attack="sf"),
            mod.BreakdownAttack("poison_lf",
                                poison=poison_cls(kind="labelflip", rate=1.0)))


@pytest.fixture(scope="module")
def reports():
    from repro.fed.poison import PoisonConfig as JPoison
    want = jbd.run_breakdown(RULES, _attacks(jbd, JPoison), **SMALL)
    params = mlp_params_from_numpy(jax.tree_util.tree_map(
        np.asarray, j_mlp_init(jax.random.PRNGKey(SMALL["seed"]), 48)))
    got = tbd.run_breakdown(RULES, _attacks(tbd, PoisonConfig), **SMALL,
                            params=params, device="cpu")
    return got, want


def test_small_sweep_equals_reference(reports):
    got, want = reports
    same_keys = ("n_clients", "fs", "rounds", "seed", "collapse_factor",
                 "window", "predicted", "n_buckets")
    assert {k: got[k] for k in same_keys} == {k: want[k] for k in same_keys}
    assert sorted(got) == sorted(want)
    assert got["n_buckets"] == 4 and got["trace_count"] == 4
    assert sorted(got["cells"]) == sorted(want["cells"])
    for rk, base in want["baseline_loss"].items():
        assert got["baseline_loss"][rk] == pytest.approx(base, rel=RTOL)
    for key, cell in want["cells"].items():
        mine = got["cells"][key]
        ref = want["baseline_loss"][key.split("|", 1)[0]]
        threshold = want["collapse_factor"] * ref
        for f, loss in cell["losses"].items():
            assert mine["losses"][f] == pytest.approx(loss, rel=RTOL), (key, f)
            near = abs(loss - threshold) <= RTOL * abs(threshold)
            if not near:
                assert mine["collapsed"][f] == cell["collapsed"][f], (key, f)
        assert mine["frontier"] == cell["frontier"] or any(
            abs(loss - threshold) <= RTOL * abs(threshold)
            for loss in cell["losses"].values()), key
    assert got["frontier"] == {k: c["frontier"] for k, c in
                               got["cells"].items()}


def test_frontier_table_equals_reference(reports):
    _, want = reports
    assert tbd.frontier_table(want) == jbd.frontier_table(want)
    assert trobustness.frontier_table is tbd.frontier_table
    assert trobustness.DEFAULT_RULES == jbd.DEFAULT_RULES
    assert [(a.name, a.attack, a.eta) for a in trobustness.DEFAULT_ATTACKS] \
        == [(a.name, a.attack, a.eta) for a in jbd.DEFAULT_ATTACKS]


def test_breakdown_validation_as_reference():
    for mod, pz in ((jbd, __import__("repro.fed.poison", fromlist=["x"])
                     .PoisonConfig), (tbd, PoisonConfig)):
        with pytest.raises(ValueError, match="not both"):
            mod.BreakdownAttack("x", attack="sf",
                                poison=pz(kind="labelflip", rate=1.0))
    for fs in ((0,), (3,), (1, 5)):
        with pytest.raises(ValueError) as j_err:
            jbd.run_breakdown(RULES, n_clients=6, fs=fs)
        with pytest.raises(ValueError) as t_err:
            tbd.run_breakdown(RULES, n_clients=6, fs=fs, device="cpu")
        assert str(t_err.value) == str(j_err.value)


def test_launcher_prints_the_example_lines(capsys):
    report = launch_breakdown.main(["--n", "4", "--rounds", "2",
                                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "empirical / theoretical frontier" in out
    assert tbd.frontier_table(report) in out
    # n = 4: f = 1 only, 5 rules x 4 attacks; the lane count is the
    # example's own reckoning (a clean lane counted per cell).
    assert "swept 20 cells (40 lanes)" in out
    assert "10 buckets" in out
    assert report["seconds"] > 0
