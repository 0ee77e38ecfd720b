"""Sequence parallelism over the decoder zoo and beside tp / ep
(``models/gpt.py``, ``models/moe.py``, the tp-aware ring and Ulysses
schedules, ``sharding.check_mesh``) against the JAX package, on the CPU.

One 4-rank gloo world (``python -m test_torch_sp_zoo DIR``,
``tests/torch_world.py``) runs every case in turn while the test process
computes the JAX side on its virtual CPU devices (``use_flash=False``:
the XLA schedules):

- attention on ``{"sp": 2, "tp": 2}``: ``ring_attention`` (the plain
  ring and the flash ring's autograd through the kernels' plain
  versions) and ``ulysses_attention`` on each rank's heads (H / tp) and
  chunk of the sequence, against the JAX functions (``heads_axis="tp"``)
  on the same mesh from the same float32 numpy inputs: the forward and
  the grads of q, k and v, reassembled over heads and sequence (a K/V
  held whole, where tp does not divide Hkv, has its gradient summed over
  the tp line), within atol 2e-5 (``tests/test_torch_sequence_parallel.py``'s);
  causal and not, GQA whose KV heads ride the all-to-all at their width
  ((Hkv / tp) % sp == 0) and whose do not, and Hkv 3 under tp 2;
- the forward of gpt_tiny and moe_tiny (capacity factor 0.5) on
  ``{"dp": 2, "sp": 2}`` at each rank's rows and chunk, against the JAX
  model's forward of the global batch, every rank's chunk, logits within
  atol 1e-4 (``tests/test_torch_gpt.py``'s): the learned positions read
  at the chunk's offset, the moe slots scanned across the sp line;
- training (``tests/torch_model_parallel.py``'s worker: 4 rows, seq 32, 3
  steps of sgd with momentum, dropout 0, float32, from the JAX
  ``Trainer``'s initial params) of gpt over ``{"dp": 2, "sp": 2}`` and
  ``{"sp": 2, "tp": 2}`` and moe over ``{"sp": 2, "ep": 2}`` at capacity
  factor 0.5, each on the ring and on Ulysses, against the JAX trainer on
  the same mesh (the tp / ep tests' tolerances: each step's loss, grad
  norm and moe's auxiliary loss and cross-entropy rtol 2e-4, equal on
  every rank; the params after the steps within 2e-4 of each leaf's
  largest element).  At capacity factor 0.5 and E 4 a row's expert takes
  8 of its 64 routes, so routes drop: moe's run without the earlier sp
  rank's counts (the planted fault ``moe_sp_prefix``) must be off the JAX
  trainer;
- dropout 0.1 over ``{"sp": 2, "tp": 2}``: the ranks of a tp line draw
  one set of masks (one seed; the weights every rank keeps whole stay
  bitwise equal), those of an sp line different ones;
- the refusals: Ulysses where a tp rank's heads do not split over sp
  (the reference's message), ``check_mesh``'s pp.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch_world import World

import torch_model_parallel as mp

torch.set_num_threads(2)

ROWS, SEED, SEQ = 4, 11, 32
#: the losses and metrics, relative; the params against each leaf's
#: largest element (tests/test_torch_tensor_parallel.py's)
RTOL = 2e-4
PARAM_TOL = 2e-4
#: the dropping capacity (module docstring)
MOE_KW = {"capacity_factor": 0.5}
#: run name -> (family, mesh, sp schedule, MoeConfig fields): held to
#: the JAX trainer on the same mesh
RUNS = {
    "gpt_ring_dp2_sp2": ("gpt", {"dp": 2, "sp": 2}, "ring", {}),
    "gpt_ulysses_dp2_sp2": ("gpt", {"dp": 2, "sp": 2}, "ulysses", {}),
    "gpt_ring_sp2_tp2": ("gpt", {"sp": 2, "tp": 2}, "ring", {}),
    "gpt_ulysses_sp2_tp2": ("gpt", {"sp": 2, "tp": 2}, "ulysses", {}),
    "moe_ring_sp2_ep2": ("moe", {"sp": 2, "ep": 2}, "ring", MOE_KW),
    "moe_ulysses_sp2_ep2": ("moe", {"sp": 2, "ep": 2}, "ulysses", MOE_KW),
}
#: the port-only runs: name -> (the run whose params and batches they
#: start from, extra spec fields)
PORT_RUNS = {
    "moe_ring_sp2_ep2_no_prefix": ("moe_ring_sp2_ep2", {"fault": "moe_sp_prefix"}),
    "gpt_ulysses_sp2_tp2_dropout": ("gpt_ulysses_sp2_tp2", {"dropout": 0.1}),
}
#: attention on {"sp": 2, "tp": 2}: [B, H, S, D] inputs; name ->
#: (schedule, causal, H, Hkv, K/V whole (tp does not divide Hkv), use_flash)
B, S, D = 2, 16, 8
ATTN_MESH = {"sp": 2, "tp": 2}
ATTN_CASES = {
    "ulysses_causal_gqa": ("ulysses", True, 4, 2, False, None),
    "ulysses_native_gqa": ("ulysses", True, 8, 4, False, None),
    "ulysses_full": ("ulysses", False, 4, 4, False, None),
    "ulysses_kv_whole": ("ulysses", True, 12, 3, True, None),
    "ring_causal_gqa": ("ring", True, 4, 2, False, None),
    "ring_full": ("ring", False, 4, 4, False, None),
    "ring_kv_whole": ("ring", True, 12, 3, True, None),
    "flash_ring_causal_gqa": ("ring", True, 4, 2, False, True),
    "flash_ring_kv_whole": ("ring", True, 12, 3, True, True),
}
#: the forwards at each rank's chunk: family -> MoeConfig fields
FORWARDS = {"gpt": {}, "moe": MOE_KW}
FWD_MESH = {"dp": 2, "sp": 2}


def _attn_inputs(case):
    _, _, h, hkv, _, _ = ATTN_CASES[case]
    r = np.random.default_rng(sorted(ATTN_CASES).index(case))
    return [r.standard_normal(s).astype(np.float32)
            for s in ((B, h, S, D), (B, hkv, S, D), (B, hkv, S, D), (B, h, S, D))]


def _heads(x, n, i):
    """Part ``i`` of ``n`` of ``x``'s heads (dim 1)."""

    w = x.shape[1] // n
    return x[:, i * w:(i + 1) * w]


def _rows_and_chunk(x, mesh_shape, dp, sp):
    rows = x.shape[0] // mesh_shape["dp"]
    chunk = x.shape[1] // mesh_shape["sp"]
    return x[dp * rows:(dp + 1) * rows, sp * chunk:(sp + 1) * chunk]


# -- the worker (each rank) ---------------------------------------------------

def worker(out_dir):
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops.ring_attention import ring_attention
    from tf_operator_tpu_torch.ops.ulysses_attention import ulysses_attention
    from tf_operator_tpu_torch.parallel.collectives import CollectiveStats
    from tf_operator_tpu_torch.parallel.mesh import make_mesh
    from tf_operator_tpu_torch.runtime.bootstrap import initialize, world

    torch.set_num_threads(1)
    initialize("cpu")
    rank, _ = world()
    mesh = make_mesh(ATTN_MESH)
    sp, tp = mesh.index(("sp",), rank), mesh.index(("tp",), rank)
    rec = {"rank": rank, "sp": sp, "tp": tp, "attn": {}}
    got = {}
    for name, (impl, causal, h, hkv, whole, use_flash) in ATTN_CASES.items():
        q, k, v, g = _attn_inputs(name)
        chunk = [slice(None), slice(None), slice(sp * S // 2, (sp + 1) * S // 2)]
        q, g = (torch.tensor(_heads(x, 2, tp)[tuple(chunk)]) for x in (q, g))
        k, v = (torch.tensor((x if whole else _heads(x, 2, tp))[tuple(chunk)]) for x in (k, v))
        q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
        fa.plain_calls.clear()
        mesh.stats = CollectiveStats()
        fn = ring_attention if impl == "ring" else ulysses_attention
        out = fn(q, k, v, mesh, causal=causal, kv_whole=whole, use_flash=use_flash)
        (out * g).sum().backward()
        for field, t in (("out", out), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
            got[f"{name}/{field}"] = t.detach().numpy()
        rec["attn"][name] = {"plain_calls": dict(fa.plain_calls),
                             "stages": mesh.stats.snapshot()}
    np.savez(os.path.join(out_dir, f"attn{rank}.npz"), **got)

    # the forwards at this rank's rows and chunk
    fmesh = make_mesh(FWD_MESH)
    dp, sp = fmesh.index(("dp",), rank), fmesh.index(("sp",), rank)
    rec["fwd"] = {"dp": dp, "sp": sp}
    ids = torch.tensor(_rows_and_chunk(np.load(os.path.join(out_dir, "fwd_ids.npy")),
                                       FWD_MESH, dp, sp))
    logits = {}
    with torch.no_grad():
        for family, moe_kw in FORWARDS.items():
            model = mp.port_model(family, mp.load_state(os.path.join(out_dir,
                                                                     f"{family}_fwd.npz")),
                                  seq=SEQ, mesh=fmesh, sp_impl="ring", **moe_kw)
            # the ranks of the rows' other chunks and rows, as a Trainer sets them
            model.set_batch_group(fmesh.group(("dp", "fsdp", "sp")))
            out = model(ids, with_aux=True) if family == "moe" else model(ids)
            if family == "moe":
                out, aux = out
                rec["fwd"]["moe_aux_share"] = float(aux)
            logits[family] = out.numpy()
    np.savez(os.path.join(out_dir, f"fwd{rank}.npz"), **logits)

    with open(os.path.join(out_dir, "spec.json")) as f:
        for spec in json.load(f):
            mp._run(spec, out_dir)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


# -- the fixture: the world and the JAX side ----------------------------------

def _jax_attention():
    """{case/field: array} of the JAX schedules on {"sp": 2, "tp": 2}."""

    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.ops.ring_attention import ring_attention
    from tf_operator_tpu.ops.ulysses_attention import ulysses_attention
    from tf_operator_tpu.parallel import make_mesh

    mesh = make_mesh(ATTN_MESH, devices=jax.devices()[:4])
    out = {}
    for name, (impl, causal, _, _, _, _) in ATTN_CASES.items():
        fn = ring_attention if impl == "ring" else ulysses_attention
        q, k, v, g = (jnp.asarray(a) for a in _attn_inputs(name))

        @jax.jit
        def fwd_bwd(q, k, v, g):
            o, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, mesh, causal=causal, use_flash=False),
                             q, k, v)
            return (o, *vjp(g))

        for field, t in zip(("out", "dq", "dk", "dv"), fwd_bwd(q, k, v, g)):
            out[f"{name}/{field}"] = np.asarray(t)
    return out


def _jax_forward(family, state, ids):
    """The JAX model's float32 logits (and moe's sown auxiliary loss) of
    the global batch ``ids``, with ``state``'s weights."""

    import jax

    from tf_operator_tpu_torch.models.weights import to_flax_params

    model = mp._jax_model(family, None, seq=SEQ, **FORWARDS[family])
    params = {"params": to_flax_params(state)}
    if family == "gpt":
        return np.asarray(model.apply(params, ids)), None
    logits, sown = model.apply(params, ids, mutable=["losses"])
    return np.asarray(logits), float(sum(jax.tree_util.tree_leaves(sown["losses"])))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_zoo")
    data = {family: mp.batches(family, ROWS, SEED, seq=SEQ) for family in ("gpt", "moe")}
    trainers, specs = {}, []
    for name, (family, shape, impl, moe_kw) in RUNS.items():
        trainers[name] = mp.jax_trainer(family, shape, data[family], impl, **moe_kw)
        mp.save_state(trainers[name]["initial"], str(tmp / f"{name}_state.npz"))
        np.savez(tmp / f"{family}_batches.npz", **data[family])
        specs.append({"name": name, "family": family, "mesh": shape, "sp_impl": impl,
                      "moe": moe_kw, "seq": SEQ, "state": str(tmp / f"{name}_state.npz"),
                      "batches": str(tmp / f"{family}_batches.npz")})
    for name, (base, extra) in PORT_RUNS.items():
        specs.append(dict([s for s in specs if s["name"] == base][0], name=name, **extra))
    (tmp / "spec.json").write_text(json.dumps(specs))
    fwd_ids = np.random.default_rng(SEED + 1).integers(0, mp.VOCAB, (ROWS, SEQ)).astype(np.int32)
    np.save(tmp / "fwd_ids.npy", fwd_ids)
    fwd_states = {"gpt": trainers["gpt_ring_dp2_sp2"]["initial"],
                  "moe": trainers["moe_ring_sp2_ep2"]["initial"]}
    for family, state in fwd_states.items():
        mp.save_state(state, str(tmp / f"{family}_fwd.npz"))
    world = World(4, [sys.executable, "-m", "test_torch_sp_zoo", str(tmp)], timeout=240)
    # the JAX side while the world runs
    jax_attn = _jax_attention()
    jax_fwd = {family: _jax_forward(family, state, fwd_ids)
               for family, state in fwd_states.items()}
    jax_runs = {name: mp.jax_train(t, data[RUNS[name][0]]) for name, t in trainers.items()}
    outs = world.wait()
    ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(4)]
    return {"tmp": tmp, "outs": outs, "ranks": ranks, "jax_attn": jax_attn,
            "jax_fwd": jax_fwd, "jax": jax_runs}


def _run_ranks(runs, name):
    return [json.loads((runs["tmp"] / f"{name}_rank{r}.json").read_text()) for r in range(4)]


def _params(runs, name):
    with np.load(runs["tmp"] / f"{name}_params.npz") as f:
        return {k: f[k] for k in f.files}


# -- attention over a tp rank's heads -----------------------------------------

def _assembled(runs, key, whole_kv):
    """The ranks' parts of ``key`` put back over heads (tp) and sequence
    (sp); a gradient of K/V held whole summed over the tp line."""

    parts = {(rec["sp"], rec["tp"]): np.load(runs["tmp"] / f"attn{rec['rank']}.npz")[key]
             for rec in runs["ranks"]}
    if whole_kv:
        return np.concatenate([parts[sp, 0] + parts[sp, 1] for sp in range(2)], axis=2)
    return np.concatenate([np.concatenate([parts[sp, tp] for tp in range(2)], axis=1)
                           for sp in range(2)], axis=2)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_sp_attention_over_tp_heads_matches_the_jax_schedule(runs, case):
    impl, _, h, hkv, whole, use_flash = ATTN_CASES[case]
    want = runs["jax_attn"]
    for field in ("out", "dq", "dk", "dv"):
        key = f"{case}/{field}"
        got = _assembled(runs, key, whole and field in ("dk", "dv"))
        np.testing.assert_allclose(got, want[key], atol=2e-5, rtol=0, err_msg=key)
    for rec in runs["ranks"]:
        calls = rec["attn"][case]["plain_calls"]
        if impl == "ring" and use_flash:
            assert "ring_attention_plain" not in calls and calls["flash_attention_fwd"] >= 1
        else:
            assert calls == {f"{impl}_attention_plain": 1}, calls


def test_ulysses_moves_kv_at_the_tp_ranks_width_where_it_splits_over_sp(runs):
    """The all-to-alls' bytes, forward and backward: q, out and their
    grads at a tp rank's H / tp heads, K and V (and their grads) at its
    Hkv / tp where that splits over sp, else expanded to H / tp."""

    unit = B * (S // 2) * D * 4
    for case, kv_width in (("ulysses_native_gqa", 2), ("ulysses_causal_gqa", 2),
                           ("ulysses_full", 2), ("ulysses_kv_whole", 6)):
        local_q = ATTN_CASES[case][2] // 2
        for rec in runs["ranks"]:
            stage = rec["attn"][case]["stages"]["ulysses_all_to_all"]
            assert stage["calls"] == 8
            assert stage["bytes"] == 2 * (2 * local_q + 2 * kv_width) * unit, (case, stage)


def test_ulysses_refuses_a_tp_ranks_heads_that_do_not_split_as_the_jax_one():
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.ops.ulysses_attention import ulysses_attention as j_ulysses
    from tf_operator_tpu.parallel import make_mesh as j_make_mesh

    from tf_operator_tpu_torch.ops.ulysses_attention import ulysses_attention
    from tf_operator_tpu_torch.parallel.mesh import make_mesh

    # 2 heads over tp 2: one local head does not split over sp 2
    q = np.zeros((1, 2, 16, 8), np.float32)
    with pytest.raises(ValueError) as jerr:
        j_ulysses(*(jnp.asarray(q),) * 3,
                  j_make_mesh(ATTN_MESH, devices=jax.devices()[:4]), causal=True,
                  use_flash=False)
    with pytest.raises(ValueError) as perr:
        ulysses_attention(*(torch.tensor(q[:, :1]),) * 3, make_mesh(ATTN_MESH, world=4),
                          causal=True)
    assert str(perr.value) == str(jerr.value)
    assert "1 local heads over sp=2" in str(perr.value)


def test_check_mesh_refuses_pp_alone():
    from tf_operator_tpu_torch.parallel.mesh import make_mesh
    from tf_operator_tpu_torch.parallel.sharding import check_mesh

    for shape in ({"sp": 2, "tp": 2}, {"sp": 2, "ep": 2}, {"dp": 2, "sp": 2}):
        check_mesh(make_mesh(shape, world=4))
    with pytest.raises(NotImplementedError) as err:
        check_mesh(make_mesh({"pp": 2, "sp": 2}, world=4))
    assert str(err.value) == ("mesh axis pp=2: the trainer runs no pipeline; pipeline "
                              "parallelism runs through models/pipelined_lm.PipelinedLM")


# -- the forwards at each rank's chunk -----------------------------------------

@pytest.mark.parametrize("family", sorted(FORWARDS))
def test_every_ranks_chunk_matches_the_jax_forward(runs, family):
    want, jax_aux = runs["jax_fwd"][family]
    for rec in runs["ranks"]:
        dp, sp = rec["fwd"]["dp"], rec["fwd"]["sp"]
        got = np.load(runs["tmp"] / f"fwd{rec['rank']}.npz")[family]
        np.testing.assert_allclose(got, _rows_and_chunk(want, FWD_MESH, dp, sp), atol=1e-4,
                                   rtol=0, err_msg=f"rank {rec['rank']} (dp {dp}, sp {sp})")
    if family == "moe":
        # each rank's share: its chunk's z-loss and the global fractions'
        # term over sp; the shares summed over sp, averaged over dp
        total = sum(rec["fwd"]["moe_aux_share"] for rec in runs["ranks"]) / FWD_MESH["dp"]
        np.testing.assert_allclose(total, jax_aux, rtol=1e-5)


# -- training -------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(RUNS))
def test_losses_match_the_jax_trainer_on_the_same_mesh(runs, name):
    ranks, want = _run_ranks(runs, name), runs["jax"][name]["metrics"]
    family, shape = RUNS[name][:2]
    keys = ("loss", "grad_norm", "token_accuracy") + (
        ("moe_aux_loss", "xent") if family == "moe" else ())
    for rec in ranks:
        assert rec["metrics"] == ranks[0]["metrics"]  # the global means on every rank
        assert {k: rec["mesh"][k] for k in shape} == shape
    assert len(ranks[0]["metrics"]) == len(want) == mp.STEPS
    for got, ref in zip(ranks[0]["metrics"], want):
        for key in keys:
            np.testing.assert_allclose(got[key], ref[key], rtol=RTOL, err_msg=key)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_trained_params_match_the_jax_trainer(runs, name):
    got, want = _params(runs, name), runs["jax"][name]["final"]
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert np.abs(got[k] - w).max() <= PARAM_TOL * max(np.abs(w).max(), 1e-6), k


@pytest.mark.parametrize("name", sorted(RUNS))
def test_ranks_hold_their_shards_and_every_weight_of_the_sp_line(runs, name):
    """A tp or ep rank holds the JAX layout's shard of each leaf split
    over its line; the position table, which the reference's rules split
    over sp, is whole on every rank (replicated over sp); the weights
    every rank keeps whole are bitwise equal over the world."""

    family, shape = RUNS[name][:2]
    want = {k: v for k, v in runs["jax"][name]["shards"].items() if k != "pos_embed"}
    ranks = _run_ranks(runs, name)
    for rec in ranks:
        held = {k: tuple(v) for k, v in rec["masters"].items()}
        assert held.pop("pos_embed") == (SEQ, 128)
        if "tp" in shape or "ep" in shape:
            assert held == want
        assert rec["whole"] == ranks[0]["whole"] and rec["whole"]


def test_sp_tp_and_sp_ep_collectives_are_counted(runs):
    stages = {name: set(_run_ranks(runs, name)[0]["stages"]) for name in RUNS}
    assert {"ulysses_all_to_all", "loss_halo", "tp_loss_all_reduce", "tp_all_reduce",
            "flat_all_reduce"} <= stages["gpt_ulysses_sp2_tp2"]
    assert {"ring_ppermute", "loss_halo", "tp_grad_all_reduce"} <= stages["gpt_ring_sp2_tp2"]
    assert {"ring_ppermute", "moe_route_counts", "ep_all_gather",
            "ep_all_reduce"} <= stages["moe_ring_sp2_ep2"]
    assert "moe_route_counts" not in stages["gpt_ring_dp2_sp2"]


def test_moe_without_the_earlier_ranks_counts_is_off_the_jax_trainer(runs):
    """The planted fault ``moe_sp_prefix``: each chunk's slots from 0, so
    rank 1 keeps routes that the whole row's queue drops, and the run
    leaves the JAX trainer's cross-entropy by more than 5 x ``RTOL`` (read
    3.2e-3), which the match above refuses."""

    got = _run_ranks(runs, "moe_ring_sp2_ep2_no_prefix")[0]["metrics"]
    want = runs["jax"]["moe_ring_sp2_ep2"]["metrics"]
    rel = max(abs(g["xent"] - w["xent"]) / abs(w["xent"]) for g, w in zip(got, want))
    assert rel > 5 * RTOL, rel


def test_dropout_masks_follow_the_sp_line_not_the_tp_line(runs):
    """At dropout 0.1 over {"sp": 2, "tp": 2}: the two ranks of a tp line
    share one dropout seed (their weights stay bitwise equal), the two
    of an sp line have different ones, and the masks move the losses."""

    ranks = _run_ranks(runs, "gpt_ulysses_sp2_tp2_dropout")
    seeds = {rec["rank"]: rec["dropout_seed"] for rec in ranks}
    # {"sp": 2, "tp": 2}: rank = 2 sp + tp
    assert seeds[0] == seeds[1] and seeds[2] == seeds[3]
    assert seeds[0] != seeds[2]
    for rec in ranks:
        assert rec["whole"] == ranks[0]["whole"]
        assert rec["metrics"] == ranks[0]["metrics"]
    plain = _run_ranks(runs, "gpt_ulysses_sp2_tp2")[0]["metrics"]
    assert all(np.isfinite(m["loss"]) for m in ranks[0]["metrics"])
    assert [m["loss"] for m in ranks[0]["metrics"]] != [m["loss"] for m in plain]


if __name__ == "__main__":
    worker(sys.argv[1])
