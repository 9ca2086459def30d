"""LLaMA2-7B — the paper's own primary evaluation model (benchmarks only)."""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="paper-llama2-7b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_head=128,
        d_ff=11008,
        vocab_size=32000,
        source="arXiv:2307.09288",
    )
