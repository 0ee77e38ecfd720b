"""The encoder families' entry points (``bert_pretrain``, ``t5_multihost``,
``vit_classify``) on the CPU, and ``bert_pretrain`` as a 2-rank job.

- each entry trains its tiny model with ``--device cpu`` (its loss falls
  over 20 steps, or ``train_loop`` exits 1) and refuses the card it does
  not have unless asked for the CPU; a ``--tp`` below 1 fails to parse,
  and one that does not divide the world (``--tp 2`` in one process) is
  refused, as the reference's assert refuses it;
- ``bert_pretrain --model bert_tiny`` as 2 ranks of one gloo world
  (``tests/torch_world.py``) over ``{"fsdp": 2}``, each on its own
  process's batch, against one process trained on both batches at once
  from the same seeded weights, at dropout 0 (masks differ between ranks
  and a process by design): each step's loss within 1e-3 relative (bf16
  compute, as ``chip_smoke.py``'s DIST_LOSS_RTOL: each rank rounds its
  gradients over its rows), the MLM mean over the global batch
  (``models/transformer.global_count``, the ranks' label counts differ);
  the sharded parameters held as shards between steps; and the job at
  its default dropout 0.1 (finite losses, other than dropout 0's).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch_world import run_world

from tf_operator_tpu_torch import bert_pretrain, t5_multihost, vit_classify

torch.set_num_threads(2)

STEPS, ROWS, SEQ = 3, 4, 16
JOB_ARGV = ["--device", "cpu", "--model", "bert_tiny", "--seq-len", str(SEQ),
            "--batch-per-device", str(ROWS), "--steps", str(STEPS), "--steps-per-sync", "1"]
#: each loss of the 2-rank job against the one process (module docstring)
JOB_RTOL = 1e-3


def worker(out_dir):
    from tf_operator_tpu_torch.runtime.bootstrap import world

    args = bert_pretrain.parse_args(JOB_ARGV)
    rec = {}
    for key, dropout in (("dropout0", 0.0), ("default", None)):
        out = bert_pretrain.run(args, dropout=dropout)
        trainer = out["trainer"]
        rec[key] = {"losses": out["losses"], "sharded": len(trainer._sharded),
                    "params": len(trainer.params),
                    "resident": trainer.resident_bytes(),
                    "full_bytes": sum(p.numel() * 4 for p in trainer.params),
                    "dropout": trainer.model.cfg.dropout}
    rank, n = world()
    rec["world"] = [rank, n]
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


@pytest.mark.parametrize("entry,argv", [
    (bert_pretrain, ["--model", "bert_tiny", "--seq-len", "32", "--batch-per-device", "8"]),
    (t5_multihost, ["--model", "t5_tiny", "--enc-len", "16", "--dec-len", "8"]),
    (vit_classify, ["--model", "vit_tiny", "--batch-per-device", "8"]),
], ids=["bert_pretrain", "t5_multihost", "vit_classify"])
def test_entry_trains_on_the_cpu(entry, argv, capsys):
    args = entry.parse_args(["--device", "cpu", "--steps", "20", "--steps-per-sync", "4"] + argv)
    out = entry.run(args)
    losses = out["losses"]
    assert len(losses) == 20 and all(np.isfinite(losses))
    assert sum(losses[-5:]) / 5 < losses[0]
    assert out["trainer"].model.cfg.dropout == 0.1  # the reference's default
    text = capsys.readouterr().out
    assert "loss" in text and "process 0/1" in text
    if entry is vit_classify:
        assert "ex/s global" in text and out["benchmark"]["examples_per_sec"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry.run(entry.parse_args(["--steps", "1"] + argv))


@pytest.mark.parametrize("entry", [t5_multihost, vit_classify], ids=["t5", "vit"])
def test_tensor_parallelism_is_refused(entry):
    with pytest.raises(ValueError, match="--tp 2 does not divide the job's 1 processes"):
        entry.run(entry.parse_args(["--device", "cpu", "--tp", "2"]))
    with pytest.raises(SystemExit):
        entry.parse_args(["--tp", "0"])


def test_bert_pretrain_fsdp_job_matches_one_process(tmp_path):
    from tf_operator_tpu_torch.models.bert import BertForPretraining, bert_tiny, mlm_loss
    from tf_operator_tpu_torch.models.weights import init_params
    from tf_operator_tpu_torch.parallel.trainer import Trainer, TrainerConfig

    outs = run_world(2, [sys.executable, "-m", "tests.test_torch_encoder_jobs", str(tmp_path)],
                     timeout=300)
    ranks = [json.loads((tmp_path / f"rank{i}.json").read_text()) for i in range(2)]
    # one process on both ranks' batches at once, from the same seeded weights
    cfg = bert_tiny(max_len=SEQ, dropout=0.0)
    model = BertForPretraining.from_state_dict(
        cfg, init_params(cfg, bert_pretrain.INIT_SEED, "cpu", trainable=True,
                         family=BertForPretraining), "cpu", trainable=True)
    trainer = Trainer(model, TrainerConfig(learning_rate=1e-4, warmup_steps=10), mlm_loss)
    parts = [bert_pretrain.synthetic_mlm_batch(r, ROWS, SEQ, 1024) for r in range(2)]
    counts = [int((p["labels"] >= 0).sum()) for p in parts]
    assert counts[0] != counts[1]  # so the global mean is what is held
    batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    want = [float(trainer.train_step(batch)["loss"]) for _ in range(STEPS)]
    for i, rec in enumerate(ranks):
        assert rec["world"] == [i, 2], outs[i][-2000:]
        got = rec["dropout0"]["losses"]
        np.testing.assert_allclose(got, want, rtol=JOB_RTOL)
        assert got == ranks[0]["dropout0"]["losses"]  # the global mean on every rank
        job = rec["dropout0"]
        assert job["sharded"] > 0 and job["dropout"] == 0.0
        # between steps a rank holds its halves of the sharded masters
        assert job["resident"]["masters"] < job["full_bytes"]
        default = rec["default"]
        assert default["dropout"] == 0.1 and all(np.isfinite(default["losses"]))
        assert default["losses"] != got


if __name__ == "__main__":
    worker(sys.argv[1])
