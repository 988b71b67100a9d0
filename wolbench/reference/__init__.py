"""The plain reference the benchmark holds the program against: PyTorch
operations only, importing nothing of the program."""
