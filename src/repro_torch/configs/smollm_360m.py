"""SmolLM-360M — llama-architecture small, tied embeddings.

[hf:HuggingFaceTB/SmolLM-135M; hf] 32L d_model=960 15H (GQA kv=5)
d_ff=2560 vocab=49152.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m",
        family="dense",
        n_layers=32,
        d_model=960,
        n_heads=15,
        n_kv_heads=5,
        d_head=64,
        d_ff=2560,
        vocab_size=49152,
        tie_embeddings=True,
        source="hf:HuggingFaceTB/SmolLM-135M",
    )
