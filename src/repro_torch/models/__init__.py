"""Models: the paper's extreme-classification model, its RNN language
model, and the dense decoder-only transformer the decode path serves."""
