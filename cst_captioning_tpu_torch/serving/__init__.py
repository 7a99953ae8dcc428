"""Serving layer of the port: the continuous-batching engine, its bucket
ladder, the exact-result cache and the JSONL front end (stdin or a
localhost socket)."""
