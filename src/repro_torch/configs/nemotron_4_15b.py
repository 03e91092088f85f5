"""nemotron-4-15b [dense], as ``repro/configs/nemotron_4_15b.py``
(arXiv:2402.16819).  32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000, squared-ReLU MLP; the untied 256k vocab stresses the loss."""
from repro_torch.configs.base import ATTN, DENSE, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", family="dense", d_model=6144, num_heads=48,
        num_kv_heads=8, d_ff=24576, vocab_size=256000,
        layout=((ATTN, DENSE),), num_super_blocks=32, mlp_act="relu2",
        pos_emb="rope", remat_policy="nothing", kv_chunk=2048)


def smoke_config() -> ModelConfig:
    return config().replace(d_model=96, num_heads=4, num_kv_heads=2,
                            d_ff=192, vocab_size=1024, num_super_blocks=2,
                            head_dim=24, remat_policy="dots", kv_chunk=16)
