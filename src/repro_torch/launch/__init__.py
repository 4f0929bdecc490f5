"""Launch layer: the training CLI."""
