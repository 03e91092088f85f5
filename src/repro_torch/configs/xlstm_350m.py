"""xlstm-350m [ssm], as ``repro/configs/xlstm_350m.py`` (arXiv:2405.04517).
24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304.
xLSTM[7:1]: an 8-block super-block (7 mLSTM + 1 sLSTM) x 3.
d_ff=0: the projection factors live inside the blocks (2.0 / 4/3).
The pure data-parallel profile (``dp_only``): every rank holds the whole
model and its rows of the batch (runtime/step.py)."""
from repro_torch.configs.base import (MLSTM, NONE, SLSTM, ModelConfig,
                                      XLSTMConfig)

_LAYOUT = ((MLSTM, NONE),) * 7 + ((SLSTM, NONE),)


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="ssm", d_model=1024, num_heads=4,
        num_kv_heads=4, d_ff=0, vocab_size=50304, head_dim=256,
        layout=_LAYOUT, num_super_blocks=3, pos_emb="none",
        xlstm=XLSTMConfig(mlstm_proj_factor=2.0, slstm_proj_factor=4.0 / 3.0,
                          chunk_size=256),
        remat_policy="dots", dp_only=True)


def smoke_config() -> ModelConfig:
    return config().replace(
        d_model=64, num_heads=2, num_kv_heads=2, vocab_size=512, head_dim=32,
        layout=((MLSTM, NONE), (SLSTM, NONE)), num_super_blocks=2,
        xlstm=XLSTMConfig(chunk_size=8))
