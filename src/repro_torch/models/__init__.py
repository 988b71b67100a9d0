"""Models: the paper's extreme-classification model."""
