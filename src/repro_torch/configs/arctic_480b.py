"""Snowflake Arctic (480B) — 128-expert top-2 MoE with parallel dense residual.

[hf:Snowflake/snowflake-arctic-base; hf] 35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000.
"""
from repro_torch.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        # the reference pads each kv group from 7 to 8 query heads (zero
        # weights, masked: the same function) for its tensor-parallel
        # layout; the port keeps the padding, so a group of 8 meets the
        # decode kernels (8 is the int8 pages' group limit)
        qhead_pad=64,
        d_head=128,
        d_ff=4864,
        vocab_size=32000,
        moe=MoEConfig(n_experts=128, top_k=2, expert_ff=4864,
                      dense_residual=True, dense_residual_ff=4864),
        source="hf:Snowflake/snowflake-arctic-base",
    )
