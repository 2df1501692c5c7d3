"""Optimizers, learning-rate schedules and gradient compression of the
port's training path (the counterparts of the JAX package's ``optim/``)."""
