"""llama3-8b [dense]: GQA, 128k vocab [arXiv:2407.21783; unverified]."""
from repro_torch.common.types import ModelConfig, replace

CONFIG = ModelConfig(
    name="llama3-8b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=128256,
    rope_theta=500000.0)

REDUCED = replace(CONFIG, num_layers=2, d_model=256, num_heads=4,
                  num_kv_heads=2, d_ff=512, vocab_size=512)
