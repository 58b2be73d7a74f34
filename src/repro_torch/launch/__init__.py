"""Entry points of the port: ``serve`` (live agentic-RAG serving) and
``profile_serve`` (where a served query's device time goes)."""
