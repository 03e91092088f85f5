"""granite-8b [dense], as ``repro/configs/granite_8b.py`` (arXiv:2405.04324).
36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152, llama-style."""
from repro_torch.configs.base import ATTN, DENSE, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b", family="dense", d_model=4096, num_heads=32,
        num_kv_heads=8, d_ff=14336, vocab_size=49152,
        layout=((ATTN, DENSE),), num_super_blocks=36, mlp_act="swiglu",
        pos_emb="rope", remat_policy="nothing", kv_chunk=2048)


def smoke_config() -> ModelConfig:
    return config().replace(d_model=96, num_heads=4, num_kv_heads=2,
                            d_ff=192, vocab_size=512, num_super_blocks=2,
                            head_dim=24, remat_policy="dots", kv_chunk=16)
