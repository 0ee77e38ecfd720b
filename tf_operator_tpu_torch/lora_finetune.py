"""LoRA fine-tuning: adapt a pretrained artifact with rank-r adapters,
train only the adapters, export a merged serving artifact (the port of
``examples/lora_finetune.py``).

    # 1) pretrain a base artifact
    python -m tf_operator_tpu_torch.llama_pretrain --steps 60 --export-dir /tmp/base
    # 2) LoRA-finetune it on another corpus draw
    python -m tf_operator_tpu_torch.lora_finetune --base /tmp/base --steps 40 \\
        --rank 8 --export-dir /tmp/tuned
    # 3) serve the tuned artifact
    python -m tf_operator_tpu_torch.serve_lm --artifact /tmp/tuned --port 8600

The base is any artifact with a ``model.json`` (gpt, llama or moe),
rebuilt trainable (float32 masters, frozen) and wrapped in
``models/lora.LoraModel``; the ``Trainer`` (AdamW at ``--learning-rate``,
the reference's config) trains the adapters on ``llama_loss`` over the
byte corpus drawn with ``--data-seed`` (7, not pretraining's 0, so that
the adapters have something new to learn).  Attention runs the flash
kernels on the card.  After training it samples 32 greedy bytes through
``models/decode.generate`` on the merged weights (a serving model, as
``serve_lm`` builds it) and, with ``--export-dir``, writes the merged
artifact (``parallel/checkpoint.export_merged_params``).

Differences from the reference: ``--device`` (cuda | cpu) in place of
``--platform``; the port's text batches (data/text.py) in place of the
grain loader; one process, one device (the reference's mesh is dp over
the host's devices).  The adapters' ``a`` is drawn from a seeded
``torch.Generator``.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

PROMPT = "the operator "
ADAPTER_SEED = 0


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True, help="export_params artifact dir")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--alpha", type=float, default=16.0)
    ap.add_argument("--learning-rate", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--data-dir", default="build/data/text-lora")
    ap.add_argument("--data-seed", type=int, default=7,
                    help="corpus seed != pretraining's so the adapters "
                         "have something new to learn")
    ap.add_argument("--export-dir", default="")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace) -> Dict:
    """The base, the LoRA trainer and the batches, and the startup lines
    (printed): everything before the first step."""

    from tf_operator_tpu_torch.data.text import TextBatches, as_lm_batches, ensure_text
    from tf_operator_tpu_torch.device import resolve_device
    from tf_operator_tpu_torch.models.llama import llama_loss
    from tf_operator_tpu_torch.models.lora import LoraModel
    from tf_operator_tpu_torch.models.registry import model_from_description
    from tf_operator_tpu_torch.parallel.checkpoint import load_model_description, load_params
    from tf_operator_tpu_torch.parallel.trainer import Trainer, TrainerConfig

    device = resolve_device(args.device)
    desc = load_model_description(args.base)
    if desc is None:
        raise SystemExit(
            f"{args.base} has no model.json — re-export the base with a "
            "current export_params"
        )
    cls, config = model_from_description(desc)
    base = cls.from_state_dict(config, load_params(args.base), device, trainable=True)
    print(f"base: family={desc['family']} from {args.base}", flush=True)
    lora = LoraModel(base, rank=args.rank, alpha=args.alpha,
                     generator=torch.Generator(device=device).manual_seed(ADAPTER_SEED))
    trainer = Trainer(lora, TrainerConfig(learning_rate=args.learning_rate), llama_loss)
    n_adapter = sum(p.numel() for p in trainer.params)
    n_base = sum(p.numel() for p in base.parameters())
    print(f"training {n_adapter:,} adapter params over a frozen "
          f"{n_base:,}-param base ({n_adapter / n_base:.2%})", flush=True)
    ensure_text(args.data_dir, seq_len=args.seq_len, seed=args.data_seed)
    batches = as_lm_batches(TextBatches(args.data_dir, args.batch, seed=args.data_seed))
    return {"device": device, "description": desc, "family": cls, "config": config,
            "base": base, "lora": lora, "trainer": trainer, "batches": iter(batches),
            "n_adapter": n_adapter, "n_base": n_base}


def finish(args: argparse.Namespace, run: Dict) -> Dict:
    """Train ``args.steps`` steps, sample on the merged weights, export;
    adds the losses (and when each printed one resolved), the merged
    state, the serving model and the sample to ``run`` and returns it."""

    from tf_operator_tpu_torch.data.text import decode_bytes
    from tf_operator_tpu_torch.models.decode import generate
    from tf_operator_tpu_torch.parallel.checkpoint import export_merged_params

    trainer, device = run["trainer"], run["device"]
    losses, resolved_at = [], []
    for step in range(args.steps):
        m = trainer.train_step(next(run["batches"]))
        losses.append(m["loss"])
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {float(m['loss']):.4f}", flush=True)
            resolved_at.append((step + 1, time.perf_counter()))
    run["losses"] = [float(x) for x in losses]
    #: (steps done, host time) at each printed loss (each resolves its step)
    run["resolved_at"] = resolved_at
    merged = run["lora"].merged_params()
    serving = run["family"].from_state_dict(run["config"], merged, device)
    prompt = torch.as_tensor(np.frombuffer(PROMPT.encode(), np.uint8).astype(np.int64))[None]
    out = generate(serving, prompt.to(device), 32)
    run["sample_ids"] = out[0, prompt.shape[1]:].tolist()
    run["sample"] = decode_bytes(np.asarray(run["sample_ids"]))
    print("sample:", repr(run["sample"]), flush=True)
    if args.export_dir:
        # the merged tree as a standard self-describing artifact
        export_merged_params(run["base"], merged, args.export_dir)
        print(f"exported merged artifact to {args.export_dir}", flush=True)
    run["merged"], run["serving"] = merged, serving
    return run


def run(args: argparse.Namespace) -> Dict:
    return finish(args, setup(args))


def main(argv: Optional[List[str]] = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
