"""Expert parallelism (the ep axis above 1; ``models/moe.py`` under
``Trainer(shardings="logical")``) against the JAX package, on the CPU:
the meshes the reference's own ep tests build (``tests/test_moe.py``).

moe_tiny (4 experts, float32; ``tests/torch_model_parallel.py``) starts
from the JAX ``Trainer``'s initial params on a mesh of host devices,
bridged into the port, and both train the same seeded global batches (4
rows, 3 steps of sgd with momentum, dropout 0); the port as the ranks of
a gloo world.  Each mesh runs at the default capacity and at the
dropping capacity of ``tests/test_torch_moe.py`` (capacity_factor 0.25:
4 slots an expert for 16 tokens, so routes are dropped).  Tolerances
(``tests/test_torch_tensor_parallel.py``'s): each step's loss, grad
norm and auxiliary loss rtol 2e-4, exactly equal across the ranks; the
params after the steps within 2e-4 of each leaf's largest element;
each rank's parameter shapes the JAX layout's shards, exactly; the
parameters a rank keeps whole bitwise equal across its ep line.

A 2-rank world runs ``{"ep": 2}`` and a 4-rank world ``{"dp": 2,
"ep": 2}`` and ``{"ep": 2, "tp": 2}`` (the experts' mlp columns split
over tp as well); ``{"ep": 2}`` also under the default rule (fsdp), which
splits no expert.
"""

import json
import sys

import numpy as np
import pytest
import torch
from torch_world import run_world

import torch_model_parallel as mp

torch.set_num_threads(2)

ROWS, SEED = 4, 7
RTOL = 2e-4
PARAM_TOL = 2e-4
#: run name -> (mesh, MoeConfig fields)
RUNS = {
    "ep2": ({"ep": 2}, {}),
    "ep2_dropping": ({"ep": 2}, {"capacity_factor": 0.25}),
    "dp2_ep2": ({"dp": 2, "ep": 2}, {}),
    "dp2_ep2_dropping": ({"dp": 2, "ep": 2}, {"capacity_factor": 0.25}),
    "ep2_tp2": ({"ep": 2, "tp": 2}, {}),
}


def _size(shape):
    return int(np.prod(list(shape.values())))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    data = mp.batches("moe", ROWS, SEED)
    np.savez(tmp / "batches.npz", **data)
    jax_runs, specs = {}, {2: [], 4: []}
    for name, (shape, moe_kw) in RUNS.items():
        jax_runs[name] = mp.jax_run("moe", shape, data, **moe_kw)
        mp.save_state(jax_runs[name]["initial"], str(tmp / f"{name}_state.npz"))
        specs[_size(shape)].append({"name": name, "family": "moe", "mesh": shape,
                                    "moe": moe_kw, "state": str(tmp / f"{name}_state.npz"),
                                    "batches": str(tmp / "batches.npz")})
    # the default rule (fsdp) over {"ep": 2}: no expert is split
    specs[2].append({"name": "ep2_fsdp_rule", "family": "moe", "mesh": {"ep": 2}, "moe": {},
                     "shardings": "fsdp", "state": str(tmp / "ep2_state.npz"),
                     "batches": str(tmp / "batches.npz")})
    outs = []
    for n, spec in specs.items():
        (tmp / f"spec{n}.json").write_text(json.dumps(spec))
        outs += run_world(n, [sys.executable, "-m", "torch_model_parallel",
                              str(tmp / f"spec{n}.json")], timeout=300)
    return {"tmp": tmp, "jax": jax_runs, "outs": outs}


def _ranks(runs, name):
    n = _size(RUNS[name][0] if name in RUNS else {"ep": 2})
    return [json.loads((runs["tmp"] / f"{name}_rank{r}.json").read_text()) for r in range(n)]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_losses_match_the_jax_trainer(runs, name):
    ranks = _ranks(runs, name)
    want = runs["jax"][name]["metrics"]
    for rec in ranks:
        assert rec["metrics"] == ranks[0]["metrics"]  # the global means on every rank
        assert {k: rec["mesh"][k] for k in RUNS[name][0]} == RUNS[name][0]
    assert len(ranks[0]["metrics"]) == len(want) == mp.STEPS
    for got, ref in zip(ranks[0]["metrics"], want):
        for key in ("loss", "grad_norm", "moe_aux_loss", "xent"):
            np.testing.assert_allclose(got[key], ref[key], rtol=RTOL, err_msg=key)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_trained_params_match_the_jax_trainer(runs, name):
    with np.load(runs["tmp"] / f"{name}_params.npz") as f:
        got = {k: f[k] for k in f.files}
    want = runs["jax"][name]["final"]
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert np.abs(got[k] - w).max() <= PARAM_TOL * max(np.abs(w).max(), 1e-6), k


@pytest.mark.parametrize("name", sorted(RUNS))
def test_each_rank_holds_its_experts(runs, name):
    want = runs["jax"][name]["shards"]
    for rec in _ranks(runs, name):
        assert {k: tuple(v) for k, v in rec["masters"].items()} == want
        assert rec["shapes"]["layers.0.moe.wi"][0] == 2  # E / ep of 4
        assert rec["shapes"]["layers.0.moe.router.kernel"] == [128, 2]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_replicated_params_stay_bitwise_equal_across_the_ep_line(runs, name):
    ranks = _ranks(runs, name)
    lines = {"ep2": [(0, 1)], "ep2_dropping": [(0, 1)], "dp2_ep2": [(0, 1), (2, 3)],
             "dp2_ep2_dropping": [(0, 1), (2, 3)], "ep2_tp2": [(0, 1, 2, 3)]}[name]
    for line in lines:
        for r in line[1:]:
            assert ranks[r]["whole"] == ranks[line[0]]["whole"]
    assert ranks[0]["whole"]


def test_ep_collectives_count_in_the_mesh_stats(runs):
    stages = set(_ranks(runs, "ep2")[0]["stages"])
    assert {"ep_all_gather", "ep_all_reduce", "ep_grad_all_reduce"} <= stages
    both = set(_ranks(runs, "ep2_tp2")[0]["stages"])
    assert {"ep_tp_all_reduce", "ep_tp_grad_all_reduce", "ep_all_gather",
            "tp_all_reduce", "tp_loss_all_reduce"} <= both
    # the batch axes' sum runs over dp alone
    assert "flat_all_reduce" in set(_ranks(runs, "dp2_ep2")[0]["stages"])


def test_the_fsdp_rule_on_an_ep_mesh_trains_whole_replicas(runs):
    """Under the ``Trainer``'s default rule (fsdp) no expert is split
    over ep: both ranks train every expert on the same rows, with no ep
    collective, and compute what the JAX trainer computes on that mesh."""

    ranks = _ranks(runs, "ep2_fsdp_rule")
    want = runs["jax"]["ep2"]
    for rec in ranks:
        assert rec["metrics"] == ranks[0]["metrics"]
        assert rec["shapes"]["layers.0.moe.wi"][0] == 4
        assert not [s for s in rec["stages"] if s.startswith("ep")], rec["stages"]
    for got, ref in zip(ranks[0]["metrics"], want["metrics"]):
        for key in ("loss", "grad_norm", "moe_aux_loss", "xent"):
            np.testing.assert_allclose(got[key], ref[key], rtol=RTOL, err_msg=key)
    assert ranks[0]["whole"] == ranks[1]["whole"]
    with np.load(runs["tmp"] / "ep2_fsdp_rule_params.npz") as f:
        for k, w in want["final"].items():
            assert np.abs(f[k] - w).max() <= PARAM_TOL * max(np.abs(w).max(), 1e-6), k


def test_dropping_capacity_drops_routes(runs):
    """At capacity_factor 0.25 the runs differ from the default capacity's
    (routes were dropped), on both sides alike."""

    for shape in ("ep2", "dp2_ep2"):
        full = [m["loss"] for m in runs["jax"][shape]["metrics"]]
        dropped = [m["loss"] for m in runs["jax"][f"{shape}_dropping"]["metrics"]]
        assert full != dropped
        got = [m["loss"] for m in _ranks(runs, f"{shape}_dropping")[0]["metrics"]]
        np.testing.assert_allclose(got, dropped, rtol=RTOL)
