"""Launch layer: the training CLI and the step builders."""
