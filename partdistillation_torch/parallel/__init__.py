"""Multi-GPU layout: the (data, model) process mesh and its collectives."""
