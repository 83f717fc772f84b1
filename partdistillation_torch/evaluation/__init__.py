"""partdistillation_torch.evaluation: see the modules of this package."""
