"""Serving: the CTR serve step and the request micro-batcher."""
