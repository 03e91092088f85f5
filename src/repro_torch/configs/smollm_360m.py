"""smollm-360m [dense], as ``repro/configs/smollm_360m.py``
(hf:HuggingFaceTB/SmolLM).  32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152, llama-style.  The pure data-parallel profile (``dp_only``):
every rank holds the whole model and its rows of the batch
(runtime/step.py), so its 15 heads never split over a model axis."""
from repro_torch.configs.base import ATTN, DENSE, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m", family="dense", d_model=960, num_heads=15,
        num_kv_heads=5, d_ff=2560, vocab_size=49152, head_dim=64,
        layout=((ATTN, DENSE),), num_super_blocks=32, mlp_act="swiglu",
        pos_emb="rope", remat_policy="dots", dp_only=True, kv_chunk=2048)


def smoke_config() -> ModelConfig:
    return config().replace(d_model=96, num_heads=3, num_kv_heads=1,
                            d_ff=192, vocab_size=512, num_super_blocks=2,
                            head_dim=32, kv_chunk=16)
