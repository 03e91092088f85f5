"""internvl2-26b [vlm], as ``repro/configs/internvl2_26b.py``
(arXiv:2404.16821).  The InternLM2 backbone: 48L d_model=6144 48H (GQA
kv=8) d_ff=16384 vocab=92553.  The ViT frontend is a stub: a batch may
carry ``patch_embeds`` [B, num_patches, d_model], prepended to the token
embeddings (models/model.py); without them the model runs on text."""
from repro_torch.configs.base import ATTN, DENSE, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b", family="vlm", d_model=6144, num_heads=48,
        num_kv_heads=8, d_ff=16384, vocab_size=92553,
        layout=((ATTN, DENSE),), num_super_blocks=48, mlp_act="swiglu",
        pos_emb="rope", frontend="patch_stub", num_patches=256,
        remat_policy="nothing", kv_chunk=2048)


def smoke_config() -> ModelConfig:
    return config().replace(d_model=96, num_heads=4, num_kv_heads=2,
                            d_ff=192, vocab_size=512, num_super_blocks=2,
                            head_dim=24, num_patches=4, remat_policy="dots",
                            kv_chunk=16)
