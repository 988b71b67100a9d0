"""Models: the paper's extreme-classification model and its RNN language
model."""
