"""Serving: the fused greedy generate engine and the KV page helpers."""
