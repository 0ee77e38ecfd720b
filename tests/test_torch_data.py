"""The port's on-disk datasets and sharded loader (``data/synthetic.py``,
``data/loader.py``) against the JAX package's, on the CPU, and
``dist_mnist --data-dir`` as a 2-rank job.

- ``ensure_mnist`` / ``ensure_imagenet_like`` / ``commit_arrays`` write
  the JAX package's bytes, file for file, and its ``meta.json``;
  regeneration over a stale dataset rewrites it; ``data/text.py`` still
  writes the JAX corpus through ``commit_arrays``;
- ``wait_for_dataset`` returns once the commit record of the asked
  parameters lands and times out on a stale one;
- ``make_loader``: the processes' shards are disjoint, each epoch covers
  whole batches of the process's shard (the remainder dropped), the
  shards are grain's (the JAX loader's record sets, epoch for epoch),
  and each epoch draws a new order (grain's order itself is not pinned:
  the port samples without grain);
- ``_normalize`` equals the JAX package's bit for bit; ``device_prefetch``
  on the CPU passes the normalised batches through as tensors;
- ``dist_mnist --data-dir D`` as 2 ranks: process 0 writes the dataset,
  process 1 waits for it, the two first batches hold disjoint records,
  and the loss falls over 20 steps on both ranks.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch_world import run_world

from tf_operator_tpu_torch.data import loader, synthetic, text

torch.set_num_threads(2)

STEPS, BATCH = 20, 16


def _files(directory):
    return {name: open(os.path.join(directory, name), "rb").read()
            for name in sorted(os.listdir(directory))}


def test_ensure_mnist_writes_the_reference_bytes(tmp_path):
    from tf_operator_tpu.data import synthetic as jsynthetic

    for kw in ({}, {"n": 600, "seed": 5, "classes": 7}):
        port, ref = tmp_path / f"port{len(kw)}", tmp_path / f"ref{len(kw)}"
        synthetic.ensure_mnist(str(port), **kw)
        jsynthetic.ensure_mnist(str(ref), **kw)
        assert _files(port) == _files(ref)
        assert json.loads((port / "meta.json").read_text()) == synthetic.mnist_meta(**kw)
        assert synthetic.mnist_meta(**kw) == jsynthetic.mnist_meta(**kw)


def test_ensure_imagenet_like_writes_the_reference_bytes(tmp_path):
    from tf_operator_tpu.data import synthetic as jsynthetic

    kw = dict(n=6, size=32, classes=100, seed=2)
    synthetic.ensure_imagenet_like(str(tmp_path / "port"), **kw)
    jsynthetic.ensure_imagenet_like(str(tmp_path / "ref"), **kw)
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    images = np.load(tmp_path / "port" / "images.npy")
    assert images.shape == (6, 32, 32, 3) and images.dtype == np.uint8


def test_commit_arrays_and_regeneration_match_the_reference(tmp_path):
    from tf_operator_tpu.data import synthetic as jsynthetic

    arrays = {"a.npy": np.arange(12, dtype=np.int16).reshape(3, 4),
              "b.npy": np.linspace(0, 1, 5, dtype=np.float32)}
    synthetic.commit_arrays(str(tmp_path / "port"), arrays, {"kind": "x", "n": 3})
    jsynthetic.commit_arrays(str(tmp_path / "ref"), arrays, {"kind": "x", "n": 3})
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    # idempotent for the same parameters, rewritten for others
    d = str(tmp_path / "mnist")
    synthetic.ensure_mnist(d, n=64)
    stamp = os.stat(os.path.join(d, "images.npy")).st_mtime_ns
    synthetic.ensure_mnist(d, n=64)
    assert os.stat(os.path.join(d, "images.npy")).st_mtime_ns == stamp
    synthetic.ensure_mnist(d, n=64, seed=1)
    jsynthetic.ensure_mnist(str(tmp_path / "ref1"), n=64, seed=1)
    assert _files(d) == _files(tmp_path / "ref1")


def test_text_corpus_is_committed_as_the_reference_commits_it(tmp_path):
    from tf_operator_tpu.data.text import ensure_text as j_ensure_text

    text.ensure_text(str(tmp_path / "port"), n_chars=4096, seq_len=64, seed=3)
    j_ensure_text(str(tmp_path / "ref"), n_chars=4096, seq_len=64, seed=3)
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    assert text.wait_for_dataset is synthetic.wait_for_dataset


def test_wait_for_dataset_waits_for_the_asked_parameters(tmp_path):
    d = str(tmp_path / "mnist")
    synthetic.ensure_mnist(d, n=32, seed=1)
    # a stale dataset (other parameters) does not satisfy the wait
    with pytest.raises(TimeoutError):
        synthetic.wait_for_dataset(d, timeout=0.5, meta=synthetic.mnist_meta(n=32))
    assert synthetic.wait_for_dataset(d, timeout=0.5) == d  # any commit record
    writer = threading.Timer(0.3, synthetic.ensure_mnist, args=(d,), kwargs={"n": 32})
    t0 = time.time()
    writer.start()
    try:
        assert synthetic.wait_for_dataset(d, timeout=30, meta=synthetic.mnist_meta(n=32)) == d
    finally:
        writer.join()
    assert time.time() - t0 >= 0.3
    assert json.loads(open(os.path.join(d, "meta.json")).read()) == synthetic.mnist_meta(n=32)


def _indexed(directory, n):
    """A dataset whose label is the record id."""

    synthetic.commit_arrays(directory, {
        "images.npy": np.zeros((n, 2, 2, 1), np.uint8),
        "labels.npy": np.arange(n, dtype=np.int32)}, {"kind": "indexed", "n": n})
    return directory


def _epochs(load, epochs):
    """The record ids of each epoch of a one-epoch-at-a-time loader."""

    return [np.concatenate([b["label"] for b in load(e)]) for e in range(epochs)]


@pytest.mark.parametrize("n,count,batch", [(96, 3, 8), (100, 3, 8), (64, 2, 5)])
def test_shards_are_disjoint_and_cover_each_epochs_records(tmp_path, n, count, batch):
    from tf_operator_tpu.data.loader import make_loader as j_make_loader

    d = _indexed(str(tmp_path / "ds"), n)
    per = n // count
    shards = []
    for pid in range(count):
        mine = loader.make_loader(d, batch, process_id=pid, process_count=count, seed=4,
                                  num_epochs=2)
        batches = list(mine)
        assert all(b["image"].shape == (batch, 2, 2, 1) for b in batches)
        got = np.concatenate([b["label"] for b in batches])
        whole = per - per % batch
        assert len(got) == 2 * whole  # whole batches of each epoch
        first, second = got[:whole], got[whole:]
        np.testing.assert_array_equal(first, mine.epoch_indices(0))
        assert len(set(first)) == whole and set(first) <= set(mine.shard)
        assert not np.array_equal(first, second)  # a new order each epoch
        # the shard is grain's: the records of the JAX loader's epochs
        ref = j_make_loader(d, batch, process_id=pid, process_count=count, seed=4,
                            num_epochs=1)
        ref_ids = np.concatenate([b["label"] for b in ref])
        assert len(ref_ids) == whole
        if per % batch == 0:
            assert set(ref_ids) == set(first) == set(mine.shard)
        assert set(ref_ids) <= set(mine.shard)
        shards.append(set(mine.shard))
    for i in range(count):
        for j in range(i + 1, count):
            assert not shards[i] & shards[j]
    assert len(set().union(*shards)) == count * per


def test_loader_takes_the_world_and_refuses_a_batch_past_its_shard(tmp_path):
    d = _indexed(str(tmp_path / "ds"), 40)
    one = loader.make_loader(d, 8, num_epochs=1, shuffle=False)
    assert list(one.shard) == list(range(40))
    np.testing.assert_array_equal(next(iter(one))["label"], np.arange(8))
    with pytest.raises(ValueError):
        loader.make_loader(d, 21, process_id=0, process_count=2)
    assert len(loader.NpySource(d)) == 40


def test_normalize_equals_the_reference():
    from tf_operator_tpu.data.loader import _normalize as j_normalize

    r = np.random.RandomState(0)
    batch = {"image": r.randint(0, 256, (5, 28, 28, 1)).astype(np.uint8),
             "label": r.randint(0, 10, 5).astype(np.int64)}
    for dtype in (np.float32, np.float16):
        got, want = loader._normalize(batch, dtype), j_normalize(batch, dtype)
        for k in ("image", "label"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_device_prefetch_passes_normalised_batches_through_on_the_cpu(tmp_path):
    d = synthetic.ensure_mnist(str(tmp_path / "mnist"), n=64)
    src = loader.make_loader(d, 8, process_id=0, process_count=1, num_epochs=1)
    got = list(loader.device_prefetch(src, "cpu"))
    want = [loader._normalize(b) for b in src]
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g["image"].dtype == torch.float32 and g["label"].dtype == torch.int32
        np.testing.assert_array_equal(g["image"].numpy(), w["image"])
        np.testing.assert_array_equal(g["label"].numpy(), w["label"])
    with pytest.raises(ValueError):
        next(loader.device_prefetch(src, "cpu", prefetch=0))


def worker(data_dir, out_dir):
    from tf_operator_tpu_torch import dist_mnist
    from tf_operator_tpu_torch.runtime.bootstrap import world

    argv = ["--device", "cpu", "--data-dir", data_dir, "--steps", str(STEPS),
            "--batch-size", str(BATCH)]
    args = dist_mnist.parse_args(argv)
    out = dist_mnist.run(args)
    rc = dist_mnist.report(args, out["losses"])
    pid, n = world()
    # the record ids of the first batch this rank trained on
    with open(os.path.join(out_dir, f"mnist{pid}.json"), "w") as f:
        json.dump({"rc": rc, "first": out["first_ids"], "world": [pid, n]}, f)


def test_dist_mnist_data_dir_runs_as_a_two_rank_job(tmp_path):
    data = str(tmp_path / "mnist")
    outs = run_world(2, [sys.executable, "-m", "tests.test_torch_data", data, str(tmp_path)],
                     timeout=300)
    recs = [json.loads((tmp_path / f"mnist{r}.json").read_text()) for r in range(2)]
    assert json.loads(open(os.path.join(data, "meta.json")).read()) == synthetic.mnist_meta()
    assert not set(recs[0]["first"]) & set(recs[1]["first"])
    for r, rec in enumerate(recs):
        assert rec["world"] == [r, 2] and rec["rc"] == 0, outs[r][-2000:]
        assert len(rec["first"]) == BATCH // 2
        line = [ln for ln in outs[r].splitlines() if ln.startswith(f"process {r}/2: steps")]
        assert line, outs[r][-2000:]
        first, last = (float(x) for x in line[0].split("loss ")[1].split(" -> "))
        assert last < first


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2])
