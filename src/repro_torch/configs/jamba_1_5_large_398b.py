"""Jamba-1.5-Large (398B) — hybrid Mamba+attention 1:7, MoE 16e top-2.

[arXiv:2403.19887; hf] 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536.  Attention layer once per 8-layer period (layer 4 of each);
the other seven are Mamba-2 SSD layers (K7 under every prefill, 128 heads
of (128, 64)).  MoE every 2nd layer, a SwiGLU on the others.  Only the
attention layers hold a KV cache, so KQ-SVD compresses one layer in 8.
"""
from repro_torch.config import HybridConfig, ModelConfig, MoEConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_head=128,
        d_ff=24576,
        vocab_size=65536,
        rope_theta=10000.0,
        hybrid=HybridConfig(period=8, attn_offset=4),
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=128,
                      n_groups=1, chunk_size=256),
        moe=MoEConfig(n_experts=16, top_k=2, expert_ff=24576,
                      every_n_layers=2),
        source="arXiv:2403.19887; hf",
    )
