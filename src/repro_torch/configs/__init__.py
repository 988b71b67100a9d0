"""Model settings of the paper's datasets."""
