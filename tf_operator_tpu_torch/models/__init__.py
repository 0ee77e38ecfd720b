"""The port's model code: the transformer families (the decoders, llama,
gpt and moe, their caches and serving pools; BERT, T5 and ViT on the
encoder half), the dist-mnist CNN and ResNet."""

from tf_operator_tpu_torch.models.bert import (
    Bert,
    BertForPretraining,
    bert_base,
    bert_tiny,
    mlm_loss,
)
from tf_operator_tpu_torch.models.gpt import CausalLM, gpt_small, gpt_tiny, lm_loss
from tf_operator_tpu_torch.models.llama import (
    LlamaLM,
    llama_7b_shape,
    llama_loss,
    llama_loss_chunked,
    llama_tiny,
    llama_wide,
)
from tf_operator_tpu_torch.models.moe import (
    MoeConfig,
    MoeDecoderLayer,
    MoeLM,
    MoeMlp,
    moe_lm_loss,
    moe_tiny,
)
from tf_operator_tpu_torch.models.t5 import T5, seq2seq_loss, t5_base, t5_tiny
from tf_operator_tpu_torch.models.transformer import TransformerConfig
from tf_operator_tpu_torch.models.vit import ViT, ViTConfig, vit_b16, vit_loss, vit_tiny

__all__ = [
    "Bert",
    "BertForPretraining",
    "bert_base",
    "bert_tiny",
    "mlm_loss",
    "CausalLM",
    "gpt_small",
    "gpt_tiny",
    "lm_loss",
    "LlamaLM",
    "llama_7b_shape",
    "llama_loss",
    "llama_loss_chunked",
    "llama_tiny",
    "llama_wide",
    "MoeConfig",
    "MoeDecoderLayer",
    "MoeLM",
    "MoeMlp",
    "moe_lm_loss",
    "moe_tiny",
    "T5",
    "seq2seq_loss",
    "t5_base",
    "t5_tiny",
    "TransformerConfig",
    "ViT",
    "ViTConfig",
    "vit_b16",
    "vit_loss",
    "vit_tiny",
]
