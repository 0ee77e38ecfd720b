"""The rounding witness for ``chip_smoke.py`` phase 5d's learning rate
(``MP_LR``).

Phase 5d holds ViT-B/16 over ``{"tp": 2}`` and the 8-expert moe over
``{"ep": 2}`` against one process at learning rate ``MP_LR``, below
their entries' own (vit_classify's 3e-3, the zoo's 1e-3).  At the
entries' rates, in bf16, the 2-rank losses leave one process's by about
2e-3 within six steps.  This script tells the rounding of the split
products' partial sums apart from a fault of the split: it runs phase
5d's ViT and moe at their entries' rates, each as 2 ranks on the card
(gloo) and as one process on the same global batch, once in bf16 (phase
5d's compute) and once in float32 (every product, partial sum and
K1-K3 launch in float32, TF32 off), with dropout 0.1 as in phase 5d.  A
split that computes what one process computes leaves, in float32, a gap
of float32's rounding carried along the trajectory; a fault of the split
would leave its gap in float32 too.

Prints each run's losses and each step's loss relative to one process's
as ``WITNESS {...}`` a dtype, then ``WITNESS_SUMMARY {...}``; exits 0
when every float32 gap is at most ``FLOAT32_BOUND``, else 1.  Needs a
CUDA card (a few minutes on an H100)::

    python3 chip_mp_witness.py
"""

import json
import os
import shutil
import sys
import tempfile

#: the largest float32 loss gap (relative, any step) that reads as
#: rounding: a tenth of phase 5d's ``DIST_LOSS_RTOL``
FLOAT32_BOUND = 1e-4
DTYPES = ("bfloat16", "float32")


def rank(data_dir: str, model_axis: int, dtype_name: str) -> None:
    """One process of the witness (a rank of its 2-rank job, or one
    process at ``model_axis`` 1): ViT-B/16 as vit_classify trains it, then
    the 8-expert moe as phase 5d trains it, both at their entries' own
    learning rates and at ``dtype_name``; prints ``RANK {...}``."""

    import torch

    import chip_smoke as c
    from tf_operator_tpu_torch import vit_classify
    from tf_operator_tpu_torch.data.text import TextBatches, as_lm_batches
    from tf_operator_tpu_torch.models.gpt import gpt_small
    from tf_operator_tpu_torch.models.moe import MoeConfig, MoeLM, moe_lm_loss
    from tf_operator_tpu_torch.models.vit import ViT, vit_b16, vit_loss
    from tf_operator_tpu_torch.models.weights import init_params
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.parallel.mesh import make_mesh
    from tf_operator_tpu_torch.parallel.trainer import Trainer, TrainerConfig
    from tf_operator_tpu_torch.runtime.bootstrap import initialize, world

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize("cuda")
    _, n = world()
    dtype = getattr(torch, dtype_name)
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}

    args = vit_classify.parse_args(["--model", "vit_b16", "--image-size", "224",
                                    "--num-classes", "1000", "--batch-per-device", "32"])
    vcfg = vit_b16(image_size=224, n_classes=1000, dtype=dtype)
    model = ViT.from_state_dict(vcfg, init_params(vcfg, vit_classify.INIT_SEED, dev,
                                                  trainable=True, family=ViT),
                                dev, trainable=True)
    mesh = make_mesh({"dp": 1, "tp": model_axis}) if n > 1 else None
    trainer = Trainer(model, TrainerConfig(optimizer="adamw", learning_rate=args.learning_rate),
                      vit_loss, mesh=mesh, shardings="logical")
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in vit_classify.make_batch(args, 32, 0).items()}
    fa.plain_calls.clear()
    out["vit"] = {"lr": args.learning_rate,
                  "losses": [float(trainer.train_step(batch)["loss"])
                             for _ in range(c.MP_VIT_STEPS)],
                  "plain_calls": {k: v for k, v in fa.plain_calls.items() if v}}
    del trainer, model, batch
    c.free_device_memory()

    cfg = MoeConfig(base=gpt_small(vocab_size=256, max_len=c.ZOO_SEQ, dtype=dtype),
                    num_experts=8)
    model = MoeLM.from_state_dict(cfg, init_params(cfg, 0, dev, trainable=True, family=MoeLM),
                                  dev, trainable=True)
    mesh = make_mesh({"ep": model_axis}) if n > 1 else None
    trainer = Trainer(model, TrainerConfig(**c.ZOO_TRAIN_CFG), moe_lm_loss, mesh=mesh,
                      shardings="logical")
    batches = iter(as_lm_batches(TextBatches(data_dir, c.ZOO_ROWS, seed=0)))
    fa.plain_calls.clear()
    out["moe"] = {"lr": c.ZOO_TRAIN_CFG["learning_rate"],
                  "losses": [float(trainer.train_step(trainer.shard_global_batch(
                      next(batches)))["loss"]) for _ in range(c.MP_MOE_STEPS)],
                  "plain_calls": {k: v for k, v in fa.plain_calls.items() if v}}
    del trainer, model
    c.free_device_memory()
    print("RANK " + json.dumps(out), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_mp_witness.py runs on a GPU", file=sys.stderr)
        return 2
    import chip_smoke as c
    from tf_operator_tpu_torch.data.text import ensure_text
    from tf_operator_tpu_torch.ops import _build

    card = c.card_line()
    _build.load("flash_attention")
    tmp = tempfile.mkdtemp(prefix="chip_mp_witness_")
    summary = {"card": card, "bound": FLOAT32_BOUND}
    try:
        data_dir = os.path.join(tmp, "text")
        ensure_text(data_dir, seq_len=c.ZOO_SEQ)
        for dtype in DTYPES:
            code = f"import chip_mp_witness as w; w.rank({data_dir!r}, {{}}, {dtype!r})"
            ranks = c._run_ranks(2, code.format(2), f"witness {dtype} job")
            one = c._run_ranks(0, code.format(1), f"witness {dtype} one process")[0]
            rec = {}
            for kind in ("vit", "moe"):
                if ranks[0][kind]["losses"] != ranks[1][kind]["losses"]:
                    raise AssertionError(f"{dtype} {kind}: the ranks' losses differ")
                rel = [abs(a - b) / abs(b) for a, b in zip(ranks[0][kind]["losses"],
                                                           one[kind]["losses"])]
                rec[kind] = {"lr": one[kind]["lr"], "one_process": one[kind]["losses"],
                             "ranks": ranks[0][kind]["losses"], "rel": rel,
                             "plain_calls": [ranks[0][kind]["plain_calls"],
                                             one[kind]["plain_calls"]]}
                summary[f"{dtype}_{kind}_rel_max"] = max(rel)
            print(f"WITNESS {dtype} ({card}) " + json.dumps(rec), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("WITNESS_SUMMARY " + json.dumps(summary), flush=True)
    worst = max(summary[f"float32_{k}_rel_max"] for k in ("vit", "moe"))
    return 0 if worst <= FLOAT32_BOUND else 1


if __name__ == "__main__":
    sys.exit(main())
