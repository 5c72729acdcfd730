"""Training: losses, optimizers, the step-loop trainer, checkpoints, logs."""
