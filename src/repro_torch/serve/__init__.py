"""Serving: prefill plus greedy or sampled decode over the KV cache."""
