"""Paper model family 2 (Fig. 6): BGE + Llama3 RAG stage models.
Embed: bge-large-en-v1.5 (0.3B), Rerank: bge-reranker-large (0.6B),
Search: Llama-3.2-1B, Chat: Llama-3.1-8B.  All INT8-quantized in the paper.
"""
from repro_torch.configs.base import ModelConfig

EMBED = ModelConfig(
    name="bge-large-en-v1.5", family="dense", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=16, head_dim=64, d_ff=4096, vocab_size=30522,
    gated_mlp=False)

RERANK = ModelConfig(
    name="bge-reranker-large", family="dense", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=16, head_dim=64, d_ff=4096, vocab_size=250002,
    gated_mlp=False)

SEARCH = ModelConfig(
    name="llama-3.2-1b", family="dense", num_layers=16, d_model=2048,
    num_heads=32, num_kv_heads=8, head_dim=64, d_ff=8192, vocab_size=128256,
    tie_embeddings=True)

CHAT = ModelConfig(
    name="llama-3.1-8b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=128256)

FAMILY = {"embed": EMBED, "rerank": RERANK, "search": SEARCH, "chat": CHAT}
