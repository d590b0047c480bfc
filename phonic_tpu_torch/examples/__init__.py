"""The JAX package's examples (``examples/``) through the port: each runs
as ``python -m phonic_tpu_torch.examples.<name>``, takes the JAX example's
flags plus ``--device`` (default ``cuda``), and renders offline with
``-o out.wav``."""
