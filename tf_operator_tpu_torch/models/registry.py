"""Describe a model as a ``model.json`` and rebuild its config from one
(the port of ``tf_operator_tpu/models/registry.py``, llama family
only).  A description the port writes has the keys the JAX package's
``describe_model`` writes, so either side can read the other's."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from tf_operator_tpu_torch.models.transformer import TransformerConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: description keys that only shape the JAX runtime, or that the port
#: sets itself when it serves (decode, paged, plain_kernels)
_IGNORED = ("sp_impl", "paged", "decode", "plain_kernels")
#: config fields of the port that a description leaves out (the mesh
#: is the training job's, as the reference's description drops it)
_PORT_ONLY = ("decode", "paged", "plain_kernels", "mesh")


def describe_model(model) -> Dict[str, Any]:
    """JSON-safe ``{"family": "llama", "config": {...}}`` of a LlamaLM."""

    from tf_operator_tpu_torch.models.llama import LlamaLM

    if not isinstance(model, LlamaLM):
        raise ValueError(f"only the llama family is ported, got {type(model).__name__}")
    cfg = {f.name: getattr(model.cfg, f.name) for f in dataclasses.fields(model.cfg)
           if f.name not in _PORT_ONLY}
    names = {v: k for k, v in _DTYPES.items()}
    cfg["dtype"] = names[model.cfg.dtype]
    # the JAX config's field the port keeps apart, at its value for a
    # llama that does not serve through the paged pool
    cfg["paged"] = None
    return {"family": "llama", "config": cfg}


def model_from_description(d: Dict[str, Any],
                           max_len: Optional[int] = None) -> TransformerConfig:
    """The TransformerConfig a ``{"family": "llama", "config": {...}}``
    description names.  ``max_len`` overrides the cache length."""

    family = d.get("family")
    if family != "llama":
        raise ValueError(f"unknown or unported model family {family!r}; known: ['llama']")
    cfg_d = {k: v for k, v in d["config"].items() if k not in _IGNORED}
    known = {f.name for f in dataclasses.fields(TransformerConfig)}
    unknown = sorted(set(cfg_d) - known)
    if unknown:
        raise ValueError(f"unknown config keys {unknown}")
    if cfg_d.get("dtype") not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {cfg_d.get('dtype')!r}")
    cfg_d["dtype"] = _DTYPES[cfg_d["dtype"]]
    if not cfg_d.get("rope"):
        raise ValueError("the llama family uses rope; the description says rope=False")
    if max_len is not None:
        cfg_d["max_len"] = int(max_len)
    return TransformerConfig(**cfg_d)
