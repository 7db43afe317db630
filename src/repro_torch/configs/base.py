"""Architecture configuration (a copy of ``repro.configs.base.ArchConfig``).

The port keeps its own copy so that it imports nothing of ``repro``.  The
fields are the reference's, so a configuration means the same model in
both packages; ``compute_dtype`` maps to torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None   # default: d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    activation: str = "silu"
    glu: bool = True                 # gated MLP (SwiGLU/GeGLU); False = plain
    tie_embeddings: bool = False
    causal: bool = True              # False: encoder-only (hubert)

    # sliding-window pattern (gemma3: 5 local : 1 global)
    window: Optional[int] = None
    global_interval: Optional[int] = None  # every k-th layer is global

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    dense_residual: bool = False     # arctic: parallel dense MLP path
    router_aux_coef: float = 0.01

    # SSM / hybrid
    ssm: Optional[str] = None        # 'rwkv6' | 'hymba'
    ssm_state: int = 16
    ssm_conv: int = 4

    # modality stubs
    modality: str = "text"           # text | audio | vlm
    frontend_dim: int = 0            # stub embedding dim (audio/vlm)
    frontend_len: int = 0            # patches/frames per sample

    # deployment
    tp_pad_heads: Optional[int] = None     # padded q-head count under TP
    tp_pad_kv_heads: Optional[int] = None  # padded kv-head count under TP
    shard_kv_heads: bool = False           # shard (padded) kv heads over model
    cache_dtype: str = "bfloat16"          # 'int8' → quantized KV cache
    serve_mlp_int8: bool = False           # w8a16 MLP weights at serving time
    prefill_chunk: int = 0                 # >0: chunked (vLLM-style) prefill
    fsdp: bool = False                     # shard weights over data axis too

    # numerics / training
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    optimizer: str = "adamw"         # adafactor for the 480B config
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    grad_compression: bool = False   # int8 error-feedback DP all-reduce

    # notes (applicability, skips) — shown by the launcher
    notes: str = ""

    # ----- derived -----
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def vocab_padded(self, tp: int = 1) -> int:
        """Vocab rounded up to 128 under TP (Megatron-style padding); padded
        classes are masked out of the softmax (models.common)."""
        if tp <= 1:
            return self.vocab
        return -(-self.vocab // 128) * 128

    def heads_for_tp(self, tp: int) -> Tuple[int, int]:
        """(q_heads, kv_heads) actually instantiated under tp-way sharding."""
        if tp <= 1:
            return self.n_heads, self.n_kv_heads
        q = self.tp_pad_heads or self.n_heads
        kv = self.tp_pad_kv_heads or self.n_kv_heads
        assert q % tp == 0, f"{self.name}: q heads {q} not divisible by tp={tp}"
        if self.shard_kv_heads:
            assert kv % tp == 0
        return q, kv

    @property
    def compute_dtype(self):
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]
