"""codeqwen1.5-7b [dense]: qwen1.5-arch [hf:Qwen/CodeQwen1.5-7B; hf]."""
from repro_torch.common.types import ModelConfig, replace

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=32, d_ff=13440, vocab_size=92416,
    rope_theta=1000000.0)

REDUCED = replace(CONFIG, num_layers=2, d_model=256, num_heads=4,
                  num_kv_heads=4, d_ff=512, vocab_size=512)
