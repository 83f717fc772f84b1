"""partdistillation_torch.models.meta_arch: see the modules of this package."""
