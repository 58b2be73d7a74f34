"""Document chunking — paper §6.1 defaults: chunk size 128 tokens,
overlap 10."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from repro_torch.rag.tokenizer import HashTokenizer


@dataclass
class Chunk:
    doc_id: int
    chunk_id: int
    token_ids: List[int]
    text: str


def chunk_documents(docs: Sequence[str], tokenizer: HashTokenizer, *,
                    chunk_size: int = 128, overlap: int = 10) -> List[Chunk]:
    assert 0 <= overlap < chunk_size
    chunks: List[Chunk] = []
    step = chunk_size - overlap
    for di, doc in enumerate(docs):
        ids = tokenizer.encode(doc)
        words = doc.split()
        if not ids:
            continue
        for ci, start in enumerate(range(0, max(len(ids) - overlap, 1), step)):
            piece = ids[start:start + chunk_size]
            if not piece:
                break
            # approximate text span (hash tokenizer is word-aligned)
            text = " ".join(words[start:start + chunk_size])
            chunks.append(Chunk(di, len(chunks), piece, text))
            if start + chunk_size >= len(ids):
                break
    return chunks
