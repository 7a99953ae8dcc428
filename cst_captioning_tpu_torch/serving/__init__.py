"""Serving layer of the port: the continuous-batching engine, its bucket
ladder and the JSONL front end."""
