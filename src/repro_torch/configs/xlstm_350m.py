"""xLSTM-350M — sLSTM + mLSTM blocks (7:1). [arXiv:2405.04517]

24L d_model=1024 4H vocab=50304, no separate FFN (mLSTM blocks are
pre-up-projection; sLSTM blocks carry a small post FFN).
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    tie_embeddings=True,
    layer_pattern=(
        "mlstm", "mlstm", "slstm", "mlstm",
        "mlstm", "mlstm", "mlstm", "mlstm",
    ),
    # chunk=512: the (B,NH,HD,HD) matrix-memory carry is snapshotted per
    # chunk by scan AD; big chunks bound that memory (see EXPERIMENTS §Perf).
    xlstm=XLSTMConfig(proj_factor=2.0, conv_kernel=4, chunk=512),
)

SMOKE_CONFIG = ModelConfig(
    name="xlstm-smoke",
    family="ssm",
    num_layers=8,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=128,
    tie_embeddings=True,
    layer_pattern=(
        "mlstm", "mlstm", "slstm", "mlstm",
        "mlstm", "mlstm", "mlstm", "mlstm",
    ),
    xlstm=XLSTMConfig(proj_factor=2.0, conv_kernel=4, chunk=8),
)
