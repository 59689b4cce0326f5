"""Training and evaluation command lines: ``python -m
roma_torch.experiments.<name>``, each with the arguments and defaults of the
JAX package's script of that name."""
