"""qwen3-moe-30b-a3b [moe], as ``repro/configs/qwen3_moe_30b_a3b.py``.
48L d_model=2048 32H (GQA kv=4) d_ff=768 vocab=151936, MoE 128e top-8,
head_dim=128.  Many fine-grained experts, so the all-to-all weighs more
than in granite-moe-3b-a800m."""
from repro_torch.configs.base import (ATTN, MOE, LSHConfig, ModelConfig,
                                      MoEConfig)


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe", d_model=2048, num_heads=32,
        num_kv_heads=4, d_ff=768, vocab_size=151936, head_dim=128,
        layout=((ATTN, MOE),), num_super_blocks=48, mlp_act="swiglu",
        moe=MoEConfig(num_experts=128, top_k=8, expert_ffn_dim=768,
                      lsh=LSHConfig(enabled=True)),
        pos_emb="rope", remat_policy="nothing", kv_chunk=2048)


def smoke_config() -> ModelConfig:
    return config().replace(
        d_model=96, num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=512,
        num_super_blocks=2, head_dim=24,
        moe=MoEConfig(num_experts=8, top_k=2, expert_ffn_dim=64,
                      lsh=LSHConfig(enabled=True, num_hashes=3,
                                    rotation_dim=16, compression_rate=0.5)),
        remat_policy="dots", kv_chunk=16)
