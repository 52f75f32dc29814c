"""Device ops of the analyse path: encodings, reads to k-mer keys (K1),
the index probe (K2) and seed-extend (K3)."""
