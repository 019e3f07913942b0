"""whisper-tiny — encoder-decoder speech model (transformer backbone only).

[arXiv:2212.04356] 4L enc + 4L dec, d_model=384, 6 heads (MHA, kv=6),
d_ff=1536, vocab=51865, a 448-token text context. The mel-spectrogram
and conv frontend are not modelled: the caller passes precomputed frame
embeddings (B, 1500, 384) as ``audio_feats``.
The same config as the JAX package's.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    arch_type="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab=51865,
    enc_dec=True,
    n_enc_layers=4,
    enc_len=1500,
    pos_embed="sinusoidal",
    superblock=(("xattn", 4, False),),
    norm="layernorm",
    act="gelu",
    use_bias=True,
    gated_mlp=False,
    dtype_name="bfloat16",
    remat=True,
    citation="[arXiv:2212.04356]",
)
