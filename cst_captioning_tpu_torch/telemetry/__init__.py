"""The training loop's metrics: counters, gauges and ``metrics.jsonl``."""
