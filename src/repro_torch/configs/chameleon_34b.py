"""chameleon-34b [vlm]: early-fusion decoder over text + VQ image tokens
[arXiv:2405.09818; unverified]. Frontend is a stub: the batch supplies
precomputed patch embeddings (the serving engines feed zeros)."""
from repro_torch.common.types import ModelConfig, replace

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm", num_layers=48, d_model=8192,
    num_heads=64, num_kv_heads=8, d_ff=22016, vocab_size=65536,
    frontend="vq_image", rope_theta=10000.0)

REDUCED = replace(CONFIG, num_layers=2, d_model=256, num_heads=8,
                  num_kv_heads=2, d_ff=512, vocab_size=512)
