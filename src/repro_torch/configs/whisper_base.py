"""whisper-base [audio], as ``repro/configs/whisper_base.py``
(arXiv:2212.04356).  Encoder-decoder, 6 + 6 layers, d_model=512 8H
d_ff=2048 vocab=51865, GELU MLPs, fixed sinusoidal positions
(``pos_emb="learned"`` names them, as in the JAX package).  The conv
frontend is a stub: a batch carries ``frames`` [B, S_enc, d_model], the
encoder's input.  ``dp_only``: every rank holds the whole model."""
from repro_torch.configs.base import ATTN, DENSE, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="audio", d_model=512, num_heads=8,
        num_kv_heads=8, d_ff=2048, vocab_size=51865,
        layout=((ATTN, DENSE),), num_super_blocks=6, mlp_act="gelu",
        pos_emb="learned", encoder_decoder=True, num_encoder_super_blocks=6,
        frontend="audio_stub", remat_policy="dots", dp_only=True,
        kv_chunk=2048)


def smoke_config() -> ModelConfig:
    return config().replace(d_model=64, num_heads=4, num_kv_heads=4,
                            d_ff=128, vocab_size=512, num_super_blocks=2,
                            num_encoder_super_blocks=2, head_dim=16,
                            kv_chunk=16)
