"""Paper model family 1 (Fig. 5): Qwen3 RAG stage models.
Embed: Qwen3-Embedding-0.6B, Rerank: Qwen3-Reranker-0.6B,
Search: Qwen3-1.7B, Chat: Qwen3-4B.  All INT8-quantized in the paper.
"""
from repro_torch.configs.base import ModelConfig

EMBED = ModelConfig(
    name="qwen3-embedding-0.6b", family="dense", num_layers=28, d_model=1024,
    num_heads=16, num_kv_heads=8, head_dim=128, d_ff=3072, vocab_size=151669,
    tie_embeddings=True)

RERANK = ModelConfig(
    name="qwen3-reranker-0.6b", family="dense", num_layers=28, d_model=1024,
    num_heads=16, num_kv_heads=8, head_dim=128, d_ff=3072, vocab_size=151669,
    tie_embeddings=True)

SEARCH = ModelConfig(
    name="qwen3-1.7b", family="dense", num_layers=28, d_model=2048,
    num_heads=16, num_kv_heads=8, head_dim=128, d_ff=6144, vocab_size=151936,
    tie_embeddings=True)

CHAT = ModelConfig(
    name="qwen3-4b", family="dense", num_layers=36, d_model=2560,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=9728, vocab_size=151936,
    tie_embeddings=True)

FAMILY = {"embed": EMBED, "rerank": RERANK, "search": SEARCH, "chat": CHAT}
