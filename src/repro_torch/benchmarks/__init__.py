"""The paper's experiments (counterpart of the JAX package's top-level
``benchmarks/`` package): Table 1's baselines and the tables' drivers."""
