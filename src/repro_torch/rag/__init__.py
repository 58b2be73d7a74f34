from repro_torch.rag.chunker import Chunk, chunk_documents  # noqa: F401
from repro_torch.rag.datasets import (  # noqa: F401
    DATASETS, QueryTrace, sample_traces, synth_documents, synth_query)
from repro_torch.rag.embedder import Embedder, Reranker  # noqa: F401
from repro_torch.rag.stages import STAGE_ROLES, build_stages  # noqa: F401
from repro_torch.rag.tokenizer import HashTokenizer  # noqa: F401
from repro_torch.rag.vectordb import VectorDB  # noqa: F401
from repro_torch.rag.workflow import (  # noqa: F401
    build_workflow, default_means, make_template, shared_corpus_traces)
