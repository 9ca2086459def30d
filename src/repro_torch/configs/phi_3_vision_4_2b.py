"""Phi-3-Vision (4.2B) — phi3-mini backbone + CLIP frontend stub.

[hf:microsoft/Phi-3-vision-128k-instruct; hf] 32L d_model=3072 32H
(MHA kv=32) d_ff=8192 vocab=32064.  [vlm]: the CLIP image tower is a stub
— a batch may carry precomputed patch embeddings (576 tokens) as
``image_embeds``, put ahead of the text tokens (``data.stub_batch`` draws
them), so the prefill's cache covers patches and text.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_head=96,
        d_ff=8192,
        vocab_size=32064,
        num_patch_tokens=576,
        source="hf:microsoft/Phi-3-vision-128k-instruct",
    )
