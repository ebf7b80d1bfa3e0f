"""Training-step machinery of the port: the fused single-pass
optimizers (``precision``) and the split train step (``train_step``).
Import the modules themselves; this package re-exports nothing."""
