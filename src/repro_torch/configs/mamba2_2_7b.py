"""Mamba2-2.7B — pure SSM (SSD), attention-free.

[arXiv:2405.21060; unverified] 64L d_model=2560 d_ff=0 vocab=50280
ssm_state=128.  No KV cache exists, so KQ-SVD has nothing to compress
(``method="none"``): the constant-size SSD state is the whole decode
state.  Prefill runs K7, the SSD chunk scan (``kernels/ssd``); decode is
the O(1) recurrent update in plain PyTorch.
"""
from repro_torch.config import CompressionConfig, ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        family="ssm",
        n_layers=64,
        d_model=2560,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,                       # Mamba-2 blocks have no separate MLP
        vocab_size=50280,
        tie_embeddings=True,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk_size=256),
        compression=CompressionConfig(method="none"),
        source="arXiv:2405.21060",
    )
