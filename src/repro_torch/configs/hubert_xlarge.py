"""hubert-xlarge [audio] — encoder-only transformer (wav2vec2-style
backbone).  48L d_model=1280 16H (MHA kv=16) d_ff=5120 vocab=504
[arXiv:2106.07447; unverified].

Encoder-only: bidirectional attention, no KV cache, no decode step.  The
CNN waveform frontend is a stub: batches carry precomputed frame
embeddings (B, S, d_model); training is masked-frame prediction over 504
cluster classes (vocab padded to 512).

Port of ``repro/configs/hubert_xlarge.py`` (same values)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    head_dim=80,
    encoder_only=True,
    frontend="audio",
    rope_theta=1e4,          # conv-positional in the original; RoPE stand-in
    group_size=1,
    source="arXiv:2106.07447; unverified",
)
