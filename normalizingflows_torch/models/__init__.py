"""Flow models: bijectors, distributions, conditioners, splines, targets."""
