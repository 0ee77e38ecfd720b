"""The port's model code: the transformer families (the llama decoder,
its caches and the paged serving pool; BERT, T5 and ViT on the encoder
half), the dist-mnist CNN and ResNet."""

from tf_operator_tpu_torch.models.bert import (
    Bert,
    BertForPretraining,
    bert_base,
    bert_tiny,
    mlm_loss,
)
from tf_operator_tpu_torch.models.llama import (
    LlamaLM,
    llama_7b_shape,
    llama_loss,
    llama_loss_chunked,
    llama_tiny,
    llama_wide,
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
    "LlamaLM",
    "llama_7b_shape",
    "llama_loss",
    "llama_loss_chunked",
    "llama_tiny",
    "llama_wide",
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
