"""Training: the step loop with microbatches, clipping and the schedule,
and fault-tolerant checkpoints in the JAX package's on-disk format."""
