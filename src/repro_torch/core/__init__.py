"""LSS core: SimHash, bucket-major tables, retrieval and Algorithm 2."""
