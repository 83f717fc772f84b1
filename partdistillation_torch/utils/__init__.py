"""partdistillation_torch.utils: see the modules of this package."""
