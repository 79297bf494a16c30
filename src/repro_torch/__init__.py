"""PyTorch/CUDA port of the serverless cold-start system (see ``repro``,
the JAX reference package beside it)."""
