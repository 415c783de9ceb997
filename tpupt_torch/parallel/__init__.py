"""Multi-GPU rendering and gradients over torch.distributed (one process a device)."""
