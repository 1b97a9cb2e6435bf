"""deepseek-7b [dense]: llama-arch MHA [arXiv:2401.02954; hf]."""
from repro_torch.common.types import ModelConfig, replace

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense", num_layers=30, d_model=4096,
    num_heads=32, num_kv_heads=32, d_ff=11008, vocab_size=102400)

REDUCED = replace(CONFIG, num_layers=2, d_model=256, num_heads=4,
                  num_kv_heads=4, d_ff=512, vocab_size=512)
