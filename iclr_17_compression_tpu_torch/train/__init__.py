"""Training: config, train state and step, schedules, meters, checkpoints,
observability, the CLI and the auxiliary trainers, and the weight bridge to
the JAX package."""
