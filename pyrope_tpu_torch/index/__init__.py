"""Index families of the port: Flat, IVF-Flat, IVF-PQ, and the numpy-only
Delta composite and VectorIndex contract they share."""
