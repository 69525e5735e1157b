"""Entry points that build the model's steps (prefill) for a shape."""
