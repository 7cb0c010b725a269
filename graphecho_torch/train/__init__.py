"""Training of the port: losses, metrics, optimizers, state, steps, trainer."""
