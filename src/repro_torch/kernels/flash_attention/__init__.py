"""GQA flash attention (causal, sliding window), differentiable."""
from .kernel import flash_attention_cuda, flash_attention_design
from .ops import flash_attention
from .ref import attention_ref

__all__ = ["attention_ref", "flash_attention", "flash_attention_cuda",
           "flash_attention_design"]
