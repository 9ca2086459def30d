"""DeepSeek-V2-Lite (16B) — MLA kv_lora=512, MoE 64 routed top-6 + 2 shared.

[arXiv:2405.04434; hf] 27L d_model=2048 16H d_ff=1408(expert) vocab=102400.
First layer dense (d_ff=10944).  MLA already stores a trained low-rank
latent cache; KQ-SVD applies post-hoc to that latent (DESIGN.md).
"""
from repro_torch.config import MLAConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="mla",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_head=128,
        d_ff=1408,
        vocab_size=102400,
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                      qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
        moe=MoEConfig(n_experts=64, top_k=6, expert_ff=1408,
                      n_shared_experts=2, first_k_dense=1,
                      first_dense_ff=10944),
        source="arXiv:2405.04434; hf",
    )
