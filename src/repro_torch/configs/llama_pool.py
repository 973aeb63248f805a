"""The paper's evaluation pool (§5 Models): Llama-family variants with a
shared 32000-token vocabulary — llama-68m, tinyllama-1.1b, llama-2-7b,
llama-2-13b — plus the small CPU-sized demo pool
(``repro.configs.llama_pool``)."""
import torch

from ..models.config import ModelConfig

ARCH_ID = "llama-pool"


def full_pool():
    """Paper-scale configs (bf16)."""
    base = dict(arch_type="dense", rope_theta=10_000.0, dtype=torch.bfloat16,
                max_position=4096, source="[paper §5 Models]")
    return [
        ModelConfig(name="llama-68m", num_layers=2, d_model=768,
                    num_heads=12, num_kv_heads=12, d_ff=3072,
                    vocab_size=32000, **base),
        ModelConfig(name="tinyllama-1.1b", num_layers=22, d_model=2048,
                    num_heads=32, num_kv_heads=4, d_ff=5632,
                    vocab_size=32000, **base),
        ModelConfig(name="llama-2-7b", num_layers=32, d_model=4096,
                    num_heads=32, num_kv_heads=32, d_ff=11008,
                    vocab_size=32000, **base),
        ModelConfig(name="llama-2-13b", num_layers=40, d_model=5120,
                    num_heads=40, num_kv_heads=40, d_ff=13824,
                    vocab_size=32000, **base),
    ]


def demo_pool(vocab_size: int = 512):
    """Small pool with the same capability ordering as the paper's
    68m : 1.1b : 7b roles (fp32)."""
    base = dict(arch_type="dense", rope_theta=10_000.0, dtype=torch.float32,
                max_position=2048, source="[paper §5, demo-scaled]")
    return [
        ModelConfig(name="demo-68m", num_layers=2, d_model=64,
                    num_heads=4, num_kv_heads=4, d_ff=256,
                    vocab_size=vocab_size, **base),
        ModelConfig(name="demo-1b", num_layers=5, d_model=160,
                    num_heads=4, num_kv_heads=4, d_ff=640,
                    vocab_size=vocab_size, **base),
        ModelConfig(name="demo-7b", num_layers=12, d_model=384,
                    num_heads=8, num_kv_heads=8, d_ff=1536,
                    vocab_size=vocab_size, **base),
    ]
