"""Entry points that build the model's steps (train, prefill, decode) for a
shape, and the training launcher."""
