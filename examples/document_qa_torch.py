"""Document QA end to end on the PyTorch port: the executable pipeline.

The port's counterpart of ``examples/document_qa.py``: the paper's
Workflow 2 for two ``finqabench`` traces with torch models — hash
tokenizer -> chunker (128/10) -> embedding model -> vector DB (the top-k
kernel) -> cross-encoder reranker -> query-rewriter agent -> chat
generation with a KV cache — dispatched by a live-backend
``HeroSession`` over heterogeneous PU executors with wall-clock dispatch.
On the card the stage models' attention runs the flash-attention (K2)
and decode-attention (K1) kernels and the search the top-k kernel (K3).

    PYTHONPATH=src python examples/document_qa_torch.py [--device cpu]
    PYTHONPATH=src python examples/document_qa_torch.py --full-width

``--full-width`` builds the published qwen3 widths in bf16 instead of the
reduced f32 configs; the models run on CUDA unless ``--device cpu``.
"""
import argparse
from typing import List, Optional, Sequence, Tuple

from repro_torch.api import HeroSession
from repro_torch.api.results import QueryResult
from repro_torch.launch.serve import build_stage_fns
from repro_torch.rag import default_means, sample_traces


def main(argv: Optional[Sequence[str]] = None
         ) -> Tuple[List[QueryResult], List[str]]:
    """-> (the queries' results, the stage of every completion streamed
    through ``on_stage_done``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--full-width", action="store_true",
                    help="published qwen3 widths in bf16")
    args = ap.parse_args(argv)

    traces = sample_traces("finqabench", 2, seed=1)
    sess = HeroSession(world="sd8gen4", family="qwen3", backend="live",
                       means=default_means(traces),
                       stage_fns=build_stage_fns(
                           device=args.device, reduced=not args.full_width))
    done: List[str] = []
    for tr in traces:
        sess.submit(tr, wf=2,
                    on_stage_done=lambda h, node, t: done.append(node.stage))
    results = sess.run(mode="isolated", timeout=600)
    for res in results:
        top = sorted(res.stage_latency.items(), key=lambda kv: -kv[1])[:3]
        hot = ", ".join(f"{s}={v:.2f}s" for s, v in top)
        print(f"query {res.qid}: {res.n_nodes} sub-stages, "
              f"{res.makespan:.2f}s wall, hottest: {hot}")
    print(f"{len(done)} stage completions streamed via on_stage_done")
    return results, done


if __name__ == "__main__":
    main()
