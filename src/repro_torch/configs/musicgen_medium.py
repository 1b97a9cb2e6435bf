"""musicgen-medium [audio]: decoder-only over EnCodec tokens
[arXiv:2306.05284; hf]. Frontend stub supplies frame embeddings (the
serving engines feed zeros)."""
from repro_torch.common.types import ModelConfig, replace

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio", num_layers=48, d_model=1536,
    num_heads=24, num_kv_heads=24, d_ff=6144, vocab_size=2048,
    frontend="encodec_audio")

REDUCED = replace(CONFIG, num_layers=2, d_model=128, num_heads=4,
                  num_kv_heads=4, d_ff=256, vocab_size=256)
