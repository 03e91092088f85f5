"""jamba-1.5-large-398b [hybrid], as ``repro/configs/jamba_1_5_large_398b.py``.
72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Mamba:attention 7:1 interleave; MoE every other layer (Jamba block
structure) => 8-layer super-block x 9.  LSH-MoE applies (MoE arch).  The
Mamba layers are Mamba-2 SSD mixers (models/ssm.py)."""
from repro_torch.configs.base import (ATTN, DENSE, MAMBA, MOE, LSHConfig,
                                      ModelConfig, MoEConfig, SSMConfig)

_LAYOUT = (
    (MAMBA, DENSE), (MAMBA, MOE), (MAMBA, DENSE), (MAMBA, MOE),
    (ATTN, DENSE), (MAMBA, MOE), (MAMBA, DENSE), (MAMBA, MOE),
)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        d_model=8192, num_heads=64, num_kv_heads=8, d_ff=24576,
        vocab_size=65536, layout=_LAYOUT, num_super_blocks=9,
        mlp_act="swiglu", pos_emb="rope",
        moe=MoEConfig(num_experts=16, top_k=2, expert_ffn_dim=24576,
                      lsh=LSHConfig(enabled=True)),
        ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk_size=256),
        remat_policy="nothing", kv_chunk=2048, train_microbatch=64)


def smoke_config() -> ModelConfig:
    return config().replace(
        d_model=128, num_heads=8, num_kv_heads=2, d_ff=256, vocab_size=512,
        num_super_blocks=1, head_dim=16,
        moe=MoEConfig(num_experts=4, top_k=2, expert_ffn_dim=128,
                      lsh=LSHConfig(enabled=True, num_hashes=3,
                                    rotation_dim=16, compression_rate=0.5)),
        ssm=SSMConfig(d_state=8, head_dim=16, expand=2, chunk_size=8),
        remat_policy="dots", kv_chunk=16)
