"""H2O-Danube-1.8B — llama/mistral mix with sliding-window attention.

[arXiv:2401.16818; hf] 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000, window=4096.  The window bounds the KV cache: decode keeps
a ring of 4096 slots per sequence (``models.attention``), and prefill
runs K6's window branch.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b",
        family="dense",
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_head=80,
        d_ff=6912,
        vocab_size=32000,
        sliding_window=4096,
        source="arXiv:2401.16818; hf",
    )
