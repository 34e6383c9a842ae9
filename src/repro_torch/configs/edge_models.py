"""The paper's four lightweight edge LLMs (§IV, Table II).

Configs from the published HF checkpoints; FP16 model sizes must land on
the paper's Table II column (TinyLlama 2.2 GB, Gemma3-1B 2.0 GB,
Llama3.2-1B 2.5 GB, DeepSeek-R1-1.5B 3.6 GB) — asserted in
tests/test_paper_validation.py.
"""
from repro_torch.core.model_config import ModelSpec

TINYLLAMA = ModelSpec(
    name="tinyllama-1.1b", family="dense",
    num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=5632, vocab_size=32000, vocab_pad_multiple=1,
)

GEMMA3_1B = ModelSpec(
    name="gemma3-1b", family="dense",
    num_layers=26, d_model=1152, num_heads=4, num_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262144, vocab_pad_multiple=1,
    sliding_window=512, local_global_ratio=5, tie_embeddings=True,
)

LLAMA32_1B = ModelSpec(
    name="llama3.2-1b", family="dense",
    num_layers=16, d_model=2048, num_heads=32, num_kv_heads=8,
    d_ff=8192, vocab_size=128256, vocab_pad_multiple=1, tie_embeddings=True,
)

DEEPSEEK_R1_15B = ModelSpec(
    # DeepSeek-R1-Distill-Qwen-1.5B (Qwen2.5-1.5B backbone).  The distill
    # checkpoint stores an UNTIED lm_head -> 1.78B stored params = 3.55 GB
    # fp16, matching the paper's 3.6 GB.
    name="deepseek-r1-1.5b", family="dense",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936, vocab_pad_multiple=1,
)

EDGE_MODELS = {m.name: m for m in (TINYLLAMA, GEMMA3_1B, LLAMA32_1B, DEEPSEEK_R1_15B)}
