"""Describe a model as a ``model.json`` and rebuild its family and config
from one (the port of ``tf_operator_tpu/models/registry.py``): the
decoder families ``gpt``, ``llama`` and ``moe``.  A description the port
writes has the keys the JAX package's ``describe_model`` writes, so
either side can read the other's:

    {"family": "gpt" | "llama", "config": {...}}
    {"family": "moe", "moe": {"num_experts", "capacity_factor",
     "aux_loss_weight", "z_loss_weight"}, "config": {...}}
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from tf_operator_tpu_torch.models.gpt import CausalLM
from tf_operator_tpu_torch.models.llama import LlamaLM
from tf_operator_tpu_torch.models.moe import MoeConfig, MoeLM
from tf_operator_tpu_torch.models.transformer import TransformerConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: description keys that only shape the JAX runtime, or that the port
#: sets itself when it serves (decode, paged, plain_kernels)
_IGNORED = ("sp_impl", "paged", "decode", "plain_kernels")
#: config fields of the port that a description leaves out (the mesh
#: is the training job's, as the reference's description drops it)
_PORT_ONLY = ("decode", "paged", "plain_kernels", "mesh")
_FAMILIES = {"gpt": CausalLM, "llama": LlamaLM, "moe": MoeLM}


def _cfg_to_dict(cfg: TransformerConfig) -> Dict[str, Any]:
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
         if f.name not in _PORT_ONLY}
    d["dtype"] = {v: k for k, v in _DTYPES.items()}[cfg.dtype]
    # the JAX config's field the port keeps apart, at its value for a
    # model that does not serve through the paged pool
    d["paged"] = None
    return d


def describe_model(model) -> Dict[str, Any]:
    """JSON-safe description of a gpt, llama or moe model."""

    for name, cls in _FAMILIES.items():
        if type(model) is cls:
            break
    else:
        raise ValueError(f"no serving description for {type(model).__name__}; "
                         f"families: {sorted(_FAMILIES)}")
    d: Dict[str, Any] = {"family": name}
    if name == "moe":
        d["moe"] = {f.name: getattr(model.moe, f.name)
                    for f in dataclasses.fields(model.moe) if f.name != "base"}
    d["config"] = _cfg_to_dict(model.cfg)
    return d


def model_from_description(d: Dict[str, Any], max_len: Optional[int] = None
                           ) -> Tuple[type, Any]:
    """(family class, config) of a description: the config is a
    ``TransformerConfig``, a ``MoeConfig`` for the moe family; build the
    model with ``cls.from_state_dict(config, state, device)``.
    ``max_len`` overrides the cache length, and is refused above the
    trained length for a family with a learned position table (decode
    past its rows is undefined; the reference raises the same)."""

    family = d.get("family")
    if family not in _FAMILIES:
        raise ValueError(f"unknown model family {family!r}; known: {sorted(_FAMILIES)}")
    cfg_d = {k: v for k, v in d["config"].items() if k not in _IGNORED}
    known = {f.name for f in dataclasses.fields(TransformerConfig)}
    unknown = sorted(set(cfg_d) - known)
    if unknown:
        raise ValueError(f"unknown config keys {unknown}")
    if cfg_d.get("dtype") not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {cfg_d.get('dtype')!r}")
    cfg_d["dtype"] = _DTYPES[cfg_d["dtype"]]
    if family == "llama" and not cfg_d.get("rope"):
        raise ValueError("the llama family uses rope; the description says rope=False")
    if max_len is not None:
        if max_len > cfg_d["max_len"] and not cfg_d.get("rope"):
            raise ValueError(
                f"max_len={max_len} exceeds the trained length {cfg_d['max_len']} and "
                f"family {family!r} uses a learned position table — extension is only "
                "defined for rope models")
        cfg_d["max_len"] = int(max_len)
    cfg = TransformerConfig(**cfg_d)
    if family == "moe":
        return MoeLM, MoeConfig(base=cfg, **d["moe"])
    return _FAMILIES[family], cfg
