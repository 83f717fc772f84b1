"""partdistillation_torch.ops: see the modules of this package."""
