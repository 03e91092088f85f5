"""phi3-mini-3.8b [dense], as ``repro/configs/phi3_mini_3_8b.py``
(arXiv:2404.14219).  32L d_model=3072 32H (kv=32: MHA) d_ff=8192
vocab=32064, RoPE and SwiGLU."""
from repro_torch.configs.base import ATTN, DENSE, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b", family="dense", d_model=3072, num_heads=32,
        num_kv_heads=32, d_ff=8192, vocab_size=32064,
        layout=((ATTN, DENSE),), num_super_blocks=32, mlp_act="swiglu",
        pos_emb="rope", remat_policy="nothing", kv_chunk=2048)


def smoke_config() -> ModelConfig:
    return config().replace(d_model=96, num_heads=4, num_kv_heads=4,
                            d_ff=192, vocab_size=512, num_super_blocks=2,
                            head_dim=24, remat_policy="dots", kv_chunk=16)
