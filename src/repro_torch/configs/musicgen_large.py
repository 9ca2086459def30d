"""MusicGen-Large — decoder-only transformer over EnCodec tokens (backbone).

[arXiv:2306.05284; hf] 48L d_model=2048 32H (MHA kv=32) d_ff=8192
vocab=2048.  [audio]: the EnCodec frontend is a stub — a batch may carry
precomputed (conditioned) frame embeddings as ``embeds`` in place of
tokens (``data.stub_batch`` draws them); the backbone and its KV cache
are real and fully compressible.  Served on token prompts.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_head=64,
        d_ff=8192,
        vocab_size=2048,
        inputs_embeds=True,
        source="arXiv:2306.05284; hf",
    )
