"""partdistillation_torch.models: see the modules of this package."""
