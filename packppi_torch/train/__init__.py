"""Training: the diffusion task, checkpoints and the epoch loop."""
