"""granite-3-8b [dense] — 40L d4096 32H (kv=8) ff=12800 V=49155. GQA.
[hf:ibm-granite] — vocab padded 49155 -> 49408 for 16-way TP.
"""
from repro_torch.core.model_config import ModelSpec

SPEC = ModelSpec(
    name="granite-3-8b", family="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=12800, vocab_size=49155,
)
