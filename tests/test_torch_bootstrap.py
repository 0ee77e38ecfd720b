"""The port's read of the operator's injection contract, against the
JAX package's, on the CPU (no processes: the joined worlds are in
``tests/test_torch_multiprocess.py``).

- ``from_env`` parses the environment that the reference's
  ``worker_env`` writes for its golden jobs (a worker-only job, a
  chief + ps + workers job, one multi-host slice, two multi-host
  slices) into the JAX ``from_env``'s fields, and
  ``detected_slice_topology`` reads the slices as the JAX one does;
- the backend rule as a table of (device, ranks on the host, visible
  GPUs) -> backend, and how the ranks on the host are read;
- ``initialize`` outside a job, or in a job of one process, joins
  nothing and returns the context (or None).
"""

import dataclasses

import pytest
import torch

from tests.testutil import new_job
from tf_operator_tpu.api.defaults import set_defaults
from tf_operator_tpu.api.types import ReplicaType
from tf_operator_tpu.bootstrap import tpu_env as j_tpu_env
from tf_operator_tpu.runtime import bootstrap as j_bootstrap

from tf_operator_tpu_torch.bootstrap import tpu_env
from tf_operator_tpu_torch.runtime import bootstrap

torch.set_num_threads(2)

#: name -> (job, the replicas whose environment is read)
GOLDEN_JOBS = {
    "worker_only": (dict(worker=2), [(ReplicaType.WORKER, 0), (ReplicaType.WORKER, 1)]),
    "chief_ps_workers": (dict(chief=1, ps=1, worker=2),
                         [(ReplicaType.CHIEF, 0), (ReplicaType.PS, 0),
                          (ReplicaType.WORKER, 0), (ReplicaType.WORKER, 1)]),
    "multihost_slice": (dict(tpu_slice=1, tpu_topology="v5e-16"),
                        [(ReplicaType.TPU_SLICE, i) for i in range(4)]),
    "two_slices": (dict(tpu_slice=2, tpu_topology="v5e-16"),
                   [(ReplicaType.TPU_SLICE, i) for i in range(8)]),
}


def test_names_are_the_reference_names():
    for name in ("ENV_COORDINATOR", "ENV_NUM_PROCESSES", "ENV_PROCESS_ID", "ENV_REPLICA_TYPE",
                 "ENV_REPLICA_INDEX", "ENV_JOB_NAME", "ENV_TELEMETRY_PORT", "ENV_TRACE_ID",
                 "ENV_PARENT_SPAN_ID", "ENV_FABRIC_PORT"):
        assert getattr(tpu_env, name) == getattr(j_tpu_env, name), name


@pytest.mark.parametrize("name", sorted(GOLDEN_JOBS))
def test_from_env_reads_the_golden_jobs_as_the_jax_bootstrap(name, monkeypatch):
    spec, replicas = GOLDEN_JOBS[name]
    job = set_defaults(new_job(**spec))
    ids = set()
    for rtype, index in replicas:
        env = j_tpu_env.worker_env(job, rtype, index)
        want = dataclasses.asdict(j_bootstrap.from_env(env))
        got = bootstrap.from_env(env)
        assert {k: v for k, v in dataclasses.asdict(got).items()
                if k not in ("backend", "device")} == want
        assert got.is_coordinator == (got.process_id == 0)
        ids.add(got.process_id)
        for k in list(env):
            monkeypatch.delenv(k, raising=False)
        for k in ("MEGASCALE_NUM_SLICES", "MEGASCALE_SLICE_ID"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert tpu_env.detected_slice_topology() == j_tpu_env.detected_slice_topology()
        assert tpu_env.detected_slice_topology(env) == j_tpu_env.detected_slice_topology()
    assert ids == set(range(len(replicas)))
    assert bootstrap.from_env({}) is None and j_bootstrap.from_env({}) is None


@pytest.mark.parametrize("env,want", [
    ({}, (1, None)),
    ({"MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": "1"}, (2, 1)),
    ({"MEGASCALE_NUM_SLICES": "x", "MEGASCALE_SLICE_ID": "y"}, (1, None)),
    ({"MEGASCALE_NUM_SLICES": "0", "MEGASCALE_SLICE_ID": ""}, (1, None)),
])
def test_detected_slice_topology_parses_as_the_jax_copy(env, want, monkeypatch):
    for k in ("MEGASCALE_NUM_SLICES", "MEGASCALE_SLICE_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tpu_env.detected_slice_topology() == j_tpu_env.detected_slice_topology() == want


#: (device, ranks on the host, visible GPUs) -> backend
BACKEND_RULE = [
    ("cpu", 1, 0, "gloo"),
    ("cpu", 4, 8, "gloo"),
    ("cuda", 1, 1, "nccl"),
    ("cuda", 2, 1, "gloo"),
    ("cuda", 4, 1, "gloo"),
    ("cuda", 4, 4, "nccl"),
    ("cuda", 2, 8, "nccl"),
    ("cuda", 8, 4, "gloo"),
]


@pytest.mark.parametrize("device,ranks,gpus,want", BACKEND_RULE)
def test_backend_rule(device, ranks, gpus, want):
    assert bootstrap.choose_backend(device, ranks, gpus) == want


def test_backend_rule_refuses_other_devices():
    with pytest.raises(ValueError):
        bootstrap.choose_backend("mps", 1, 0)


def test_ranks_on_the_host():
    def ctx(addr, n=4):
        return bootstrap.JobContext("j", "worker", 0, 0, n, addr)

    assert bootstrap.ranks_on_host(ctx("127.0.0.1:1234"), {}) == 4
    assert bootstrap.ranks_on_host(ctx("localhost:1234"), {}) == 4
    assert bootstrap.ranks_on_host(ctx("job-worker-0.default.svc:8476"), {}) == 1
    assert bootstrap.ranks_on_host(ctx("job-worker-0.default.svc:8476"),
                                   {"LOCAL_WORLD_SIZE": "2"}) == 2


def test_single_process_initialize_is_a_no_op(monkeypatch):
    import torch.distributed as dist

    for k in ("TPUJOB_COORDINATOR_ADDRESS", "TPUJOB_NUM_PROCESSES", "TPUJOB_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert bootstrap.initialize("cpu") is None
    assert bootstrap.world() == (0, 1)
    monkeypatch.setenv("TPUJOB_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("TPUJOB_NUM_PROCESSES", "1")
    monkeypatch.setenv("TPUJOB_PROCESS_ID", "0")
    ctx = bootstrap.initialize("cpu")
    assert ctx is not None and ctx.num_processes == 1 and ctx.backend == ""
    assert not dist.is_initialized()
    assert bootstrap.entry_device("cpu", ctx) == torch.device("cpu")
